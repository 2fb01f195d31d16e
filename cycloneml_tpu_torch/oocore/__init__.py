"""Out-of-core streaming epoch engine: fits on datasets larger than the
card's memory.

The port's counterpart of ``cycloneml_tpu/oocore/``. A dataset becomes a
sequence of bounded shard files on disk with the fit statistics harvested
in the same write pass (``shards.StreamingDataset``); an epoch streams
them through pinned staging buffers and a copy stream onto device slots
(``stream.ShardStream``), the copy of shard i+1 overlapping the kernel of
shard i; the objective runs the same aggregator as the in-core fit once a
shard (K1, K2 or K1s on the card) and adds the partials in float64 in
staging order (``objective.StreamingLossFunction``); ``engine`` makes
streaming a fit mode (``cyclone.oocore.mode=force``, a ``StreamingDataset``
handed to ``fit``, or the budget guard's degradation); ``cache`` reuses a
spill across fits of the same data.
"""

from cycloneml_tpu_torch.observe.costs import OutOfCoreRequired
from cycloneml_tpu_torch.oocore.cache import ShardSetCache, shard_set_cache
from cycloneml_tpu_torch.oocore.engine import (StreamingGradientDescent,
                                               degrade_allowed,
                                               shard_dataset, streaming_mode)
from cycloneml_tpu_torch.oocore.objective import (
    StackedStreamingLossFunction, StreamingLossFunction)
from cycloneml_tpu_torch.oocore.shards import StreamingDataset
from cycloneml_tpu_torch.oocore.stream import ShardStream

__all__ = [
    "StreamingDataset", "ShardStream", "StreamingLossFunction",
    "StackedStreamingLossFunction", "StreamingGradientDescent",
    "OutOfCoreRequired", "shard_dataset", "streaming_mode",
    "degrade_allowed", "ShardSetCache", "shard_set_cache",
]
