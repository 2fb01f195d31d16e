"""Test fixtures.

The ``local-mesh`` fixture replaces the reference's ``local-cluster[n,c,m]``
trick (ref: SparkContext.scala:3058, used by DistributedSuite:35): instead of
spawning worker processes, we force the JAX host platform to expose 8 virtual
CPU devices and run the full SPMD path (shard_map + psum) on a real 8-way
mesh in-process.

Env must be set before jax initializes its backends — hence the top of this
file, which pytest imports before any test module.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: scale/ledger tests (minutes, subprocesses)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")

from cycloneml_tpu import mesh as mesh_mod  # noqa: E402
from cycloneml_tpu.conf import CycloneConf  # noqa: E402
from cycloneml_tpu.context import CycloneContext  # noqa: E402


@pytest.fixture(scope="session")
def ctx():
    """Shared context over a local-mesh[8] (≈ SharedSparkContext:24)."""
    conf = CycloneConf().set("cyclone.master", "local-mesh[8]")
    c = CycloneContext(conf)
    yield c
    c.stop()


@pytest.fixture(scope="session", autouse=True)
def thread_audit():
    """Leak check for NON-daemon threads (≈ SparkFunSuite's ThreadAudit,
    SparkFunSuite.scala:44-49). Daemon threads (listener buses, trigger
    loops, metrics) die with the process and are exempt, as the reference
    exempts its known daemon pools."""
    import threading
    # process-lifetime pools, exempt like the reference exempts its known
    # pools (rpc/netty/forkjoin): the shared partition-task executor
    allowed_prefixes = ("cyclone-task",)
    before = {t.name for t in threading.enumerate() if not t.daemon}
    yield
    leaked = [t for t in threading.enumerate()
              if not t.daemon and t.is_alive() and t.name not in before
              and not t.name.startswith(allowed_prefixes)]
    assert not leaked, f"non-daemon threads leaked by tests: {leaked}"
