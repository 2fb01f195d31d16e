// cyclone_host: the port's native host scanner.
//
// The libsvm and CSV parsers of the framework's host runtime, compiled by
// g++ at first use (cycloneml_tpu_torch/native/__init__.py) and loaded with
// ctypes:
//   * svm_open / svm_fill / svm_free: a whole libsvm file, parsed by n
//     threads, into dense float32 rows;
//   * svm_stream_open / _open_range / _next / _free: a libsvm file streamed
//     in bounded memory as CSR chunks (labels, per-row nnz, flat 0-based
//     ids and values), optionally one byte range of it (a split);
//   * csv_open / csv_fill / csv_free: a numeric CSV file into dense float64
//     rows.
//
// The parse of a row is the same in every entry point (strtod labels, ids
// 1-based on disk, strtof values, a plain-integer value read directly), and
// the rows of a window come out in file order whatever the thread count.
//
// Pure C ABI; every handle is used by one thread at a time.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// loader
// ---------------------------------------------------------------------------

struct SvmRow {
  double label;  // f64: regression targets must survive the round trip
  std::vector<std::pair<int32_t, float>> feats;
};

struct SvmFile {
  std::vector<SvmRow> rows;
  int64_t n_features = 0;
};

static void parse_svm_range(const char* data, size_t begin, size_t end,
                            std::vector<SvmRow>* out, int64_t* max_idx) {
  size_t pos = begin;
  int64_t local_max = -1;
  while (pos < end) {
    size_t eol = pos;
    while (eol < end && data[eol] != '\n') eol++;
    const char* p = data + pos;
    const char* stop = data + eol;
    pos = eol + 1;
    while (p < stop && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    if (p >= stop || *p == '#') continue;
    SvmRow row;
    char* next = nullptr;
    row.label = strtod(p, &next);
    if (next == p) continue;
    p = next;
    while (p < stop) {
      while (p < stop && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
      if (p >= stop) break;
      long idx = strtol(p, &next, 10);
      if (next == p || *next != ':') break;
      p = next + 1;
      float v = strtof(p, &next);
      if (next == p) break;
      p = next;
      row.feats.emplace_back((int32_t)(idx - 1), v);  // libsvm is 1-based
      if (idx - 1 > local_max) local_max = idx - 1;
    }
    out->push_back(std::move(row));
  }
  *max_idx = local_max;
}

// Flat CSR output for the STREAM path: per-row std::vector allocations in
// SvmRow dominate single-core parse time at Criteo row rates; the flat
// form appends into four growing arrays and hands chunks out via memcpy.
struct SvmFlat {
  std::vector<double> y;
  std::vector<int32_t> nnz;
  std::vector<int32_t> idx;
  std::vector<float> val;
};

static inline const char* svm_skip_ws(const char* p, const char* stop) {
  while (p < stop && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

static void parse_svm_range_flat(const char* data, size_t begin, size_t end,
                                 SvmFlat* out, int64_t* max_idx) {
  size_t pos = begin;
  int64_t local_max = -1;
  while (pos < end) {
    size_t eol = pos;
    while (eol < end && data[eol] != '\n') eol++;
    const char* p = data + pos;
    const char* stop = data + eol;
    pos = eol + 1;
    p = svm_skip_ws(p, stop);
    if (p >= stop || *p == '#') continue;
    char* next = nullptr;
    double label = strtod(p, &next);
    if (next == p) continue;
    p = next;
    int32_t count = 0;
    while (p < stop) {
      p = svm_skip_ws(p, stop);
      if (p >= stop) break;
      // manual index parse (strtol's locale/overflow machinery is the
      // single hottest line at tens of millions of tokens)
      const char* q = p;
      bool neg = false;
      if (*q == '-' || *q == '+') { neg = (*q == '-'); q++; }
      const char* d0 = q;
      long idxv = 0;
      while (q < stop && *q >= '0' && *q <= '9') {
        idxv = idxv * 10 + (*q - '0');
        q++;
      }
      if (q == d0 || q - d0 > 18 || q >= stop || *q != ':') break;
      if (neg) idxv = -idxv;
      p = q + 1;
      // fast value path: a plain integer token (the common hashed-count
      // case) converts directly; anything else falls back to strtof
      float v;
      q = p;
      neg = false;
      if (q < stop && (*q == '-' || *q == '+')) { neg = (*q == '-'); q++; }
      d0 = q;
      long mant = 0;
      while (q < stop && *q >= '0' && *q <= '9') {
        mant = mant * 10 + (*q - '0');
        q++;
      }
      if (q > d0 && q - d0 <= 18 &&
          (q >= stop || *q == ' ' || *q == '\t' || *q == '\r')) {
        v = (float)(neg ? -mant : mant);
        p = q;
      } else {
        v = strtof(p, &next);
        if (next == p) break;
        p = next;
      }
      out->idx.push_back((int32_t)(idxv - 1));  // libsvm is 1-based
      out->val.push_back(v);
      count++;
      if (idxv - 1 > local_max) local_max = idxv - 1;
    }
    out->y.push_back(label);
    out->nnz.push_back(count);
  }
  *max_idx = local_max;
}

// The whole of a regular file into *buf; false if it is not one (a
// directory opens, but has no size to read) or a read fails.
static bool read_whole(const char* path, std::vector<char>* buf) {
  struct stat st;
  if (stat(path, &st) != 0 || !S_ISREG(st.st_mode)) return false;
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  std::streamoff end = f.tellg();
  if (end < 0) return false;
  f.seekg(0);
  buf->resize((size_t)end);
  return end == 0 || (bool)f.read(buf->data(), end);
}

// Parse whole file with n threads; returns handle, row/feature counts.
void* svm_open(const char* path, int n_threads, int64_t* n_rows,
               int64_t* n_features) {
  std::vector<char> buf;
  if (!read_whole(path, &buf)) return nullptr;
  size_t size = buf.size();

  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (size < (size_t)(nt * 4096)) nt = 1;

  // chunk boundaries snapped to newlines
  std::vector<size_t> bounds(nt + 1, 0);
  bounds[nt] = size;
  for (int i = 1; i < nt; i++) {
    size_t b = size * i / nt;
    while (b < size && buf[b] != '\n') b++;
    bounds[i] = b < size ? b + 1 : size;
  }
  std::vector<std::vector<SvmRow>> parts(nt);
  std::vector<int64_t> maxes(nt, -1);
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; i++)
    threads.emplace_back(parse_svm_range, buf.data(), bounds[i], bounds[i + 1],
                         &parts[i], &maxes[i]);
  for (auto& t : threads) t.join();

  auto* out = new SvmFile();
  int64_t mx = -1;
  for (int i = 0; i < nt; i++) {
    if (maxes[i] > mx) mx = maxes[i];
    for (auto& r : parts[i]) out->rows.push_back(std::move(r));
  }
  out->n_features = mx + 1;
  *n_rows = (int64_t)out->rows.size();
  *n_features = out->n_features;
  return out;
}

// Fill dense row-major x (n_rows × n_features) and y (n_rows).
int svm_fill(void* h, float* x, float* y, int64_t n_rows, int64_t n_features) {
  auto* f = (SvmFile*)h;
  if ((int64_t)f->rows.size() != n_rows) return -1;
  memset(x, 0, sizeof(float) * (size_t)(n_rows * n_features));
  for (int64_t r = 0; r < n_rows; r++) {
    y[r] = (float)f->rows[r].label;
    float* row = x + r * n_features;
    for (auto& kv : f->rows[r].feats)
      if (kv.first >= 0 && kv.first < n_features) row[kv.first] = kv.second;
  }
  return 0;
}

void svm_free(void* h) { delete (SvmFile*)h; }

// -- streaming libsvm (bounded memory) --------------------------------------
//
// The whole-file loader above materializes every row before filling a dense
// buffer — fine for datasets that fit host RAM, unusable for the
// Criteo-1TB class. The stream reads a fixed byte window at a time,
// multithread-parses it, and hands rows out chunk-by-chunk in CSR form
// (labels + per-row nnz + flat (index, value) pairs); peak memory is
// O(window + parsed-window rows), independent of file size.

struct SvmStream {
  FILE* f = nullptr;
  std::string carry;  // partial trailing line of the last window
  SvmFlat pend;       // parsed rows not yet handed out (flat CSR)
  size_t prow = 0;    // next pending row
  size_t pnz = 0;     // offset of that row's nonzeros in pend.idx/val
  int64_t buf_bytes;
  int nt;
  bool eof = false;
  bool failed = false;   // a read of the file failed (ferror)
  int64_t max_idx = -1;  // max feature index seen so far (running)
  int64_t pos = 0;       // absolute file offset of the next unread byte
  int64_t limit = -1;    // split end (-1 = whole file): lines STARTING at
                         // offset <= limit are ours (HadoopRDD
                         // LineRecordReader split semantics)
};

void* svm_stream_open(const char* path, int64_t buf_bytes, int n_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new SvmStream();
  s->f = f;
  s->buf_bytes = buf_bytes > 0 ? buf_bytes : (8 << 20);
  s->nt = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (s->nt < 1) s->nt = 1;
  return s;
}

void svm_stream_free(void* h);

// Byte-range split reader (ref: core/.../rdd/HadoopRDD.scala:87 +
// LineRecordReader): a split [start, end) skips through the first newline
// when start > 0 (that partial/boundary line belongs to the previous
// split, which reads one line PAST its end), and keeps every line whose
// first byte sits at offset <= end.
void* svm_stream_open_range(const char* path, int64_t buf_bytes,
                            int n_threads, int64_t start, int64_t end) {
  auto* s = (SvmStream*)svm_stream_open(path, buf_bytes, n_threads);
  if (!s) return nullptr;
  if (start > 0) {
    if (fseek(s->f, (long)start, SEEK_SET) != 0) {
      svm_stream_free(s);
      return nullptr;
    }
    s->pos = start;
    // discard through the first newline
    int c;
    while ((c = fgetc(s->f)) != EOF) {
      s->pos++;
      if (c == '\n') break;
    }
    if (c == EOF && ferror(s->f)) {
      svm_stream_free(s);
      return nullptr;
    }
    if (c == EOF) s->eof = true;
    // the skip consumed past the split end: every line starting in
    // [start, end] belonged to the previous split's read-one-line-past-
    // end — emitting the next line here would duplicate it with the
    // split that owns it (splits narrower than one line)
    if (end >= 0 && s->pos > end) s->eof = true;
  }
  s->limit = end;
  return s;
}

static bool svm_stream_refill(SvmStream* s) {
  // read windows until one parses to at least one row (comment-only windows
  // and longer-than-window lines retry) or genuine EOF. A loop, not
  // recursion: each skipped window must release its buffer and stack frame
  // before the next (a multi-GB comment region would otherwise hold every
  // window alive at once).
 retry:
  // read one window, snap to the last newline, parse it in parallel
  std::vector<char> buf;
  buf.reserve(s->carry.size() + (size_t)s->buf_bytes);
  buf.insert(buf.end(), s->carry.begin(), s->carry.end());
  s->carry.clear();
  size_t old = buf.size();
  int64_t win_start = s->pos - (int64_t)old;  // abs offset of buf[0]
  buf.resize(old + (size_t)s->buf_bytes);
  size_t got = fread(buf.data() + old, 1, (size_t)s->buf_bytes, s->f);
  buf.resize(old + got);
  s->pos += (int64_t)got;
  if (got < (size_t)s->buf_bytes) {
    // a short read is the end of the file, or an error that must not
    // pass for one (the caller would get a truncated dataset)
    if (ferror(s->f)) {
      s->failed = true;
      return false;
    }
    s->eof = true;
  }
  if (buf.empty()) return false;

  if (s->limit >= 0 && win_start + (int64_t)buf.size() > s->limit) {
    // split end inside this window: keep through the first newline at
    // abs offset >= limit (the line STARTING at limit is still ours;
    // the next split discards it as its partial first line)
    size_t cut = s->limit > win_start ? (size_t)(s->limit - win_start) : 0;
    while (cut < buf.size() && buf[cut] != '\n') cut++;
    if (cut < buf.size()) {
      buf.resize(cut + 1);
      s->eof = true;
    }
    // newline not in window yet: the final line spills past it — fall
    // through; the carry logic keeps reading until it completes
  }

  size_t end = buf.size();
  if (!s->eof) {
    // hold back the partial final line for the next window
    size_t last_nl = end;
    while (last_nl > 0 && buf[last_nl - 1] != '\n') last_nl--;
    if (last_nl == 0) {
      // a single line longer than the window: grow the carry and retry
      s->carry.assign(buf.begin(), buf.end());
      goto retry;
    }
    s->carry.assign(buf.begin() + last_nl, buf.end());
    end = last_nl;
  }

  int nt = s->nt;
  if (end < (size_t)(nt * 4096)) nt = 1;
  std::vector<size_t> bounds(nt + 1, 0);
  bounds[nt] = end;
  for (int i = 1; i < nt; i++) {
    size_t b = end * i / nt;
    while (b < end && buf[b] != '\n') b++;
    bounds[i] = b < end ? b + 1 : end;
  }
  std::vector<SvmFlat> parts(nt);
  std::vector<int64_t> maxes(nt, -1);
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; i++)
    threads.emplace_back(parse_svm_range_flat, buf.data(), bounds[i],
                         bounds[i + 1], &parts[i], &maxes[i]);
  for (auto& t : threads) t.join();
  s->pend.y.clear();
  s->pend.nnz.clear();
  s->pend.idx.clear();
  s->pend.val.clear();
  s->prow = 0;
  s->pnz = 0;
  for (int i = 0; i < nt; i++) {
    if (maxes[i] > s->max_idx) s->max_idx = maxes[i];
    SvmFlat& p = s->pend;
    p.y.insert(p.y.end(), parts[i].y.begin(), parts[i].y.end());
    p.nnz.insert(p.nnz.end(), parts[i].nnz.begin(), parts[i].nnz.end());
    p.idx.insert(p.idx.end(), parts[i].idx.begin(), parts[i].idx.end());
    p.val.insert(p.val.end(), parts[i].val.begin(), parts[i].val.end());
  }
  // a window of only comments/blank lines parses to zero rows; that is not
  // end-of-stream
  if (s->pend.y.empty() && !s->eof) goto retry;
  return !s->pend.y.empty();
}

// Fill up to max_rows rows (CSR: y, row_nnz, flat idx/val capped at cap_nnz).
// Returns rows filled; 0 at end of stream; -2 if a single row's nnz exceeds
// cap_nnz (caller must grow the buffer); -3 if a read of the file failed.
// max_feature reports the running max feature index + 1 over everything
// parsed so far.
int64_t svm_stream_next(void* h, double* y, int32_t* row_nnz, int32_t* idx,
                        float* val, int64_t max_rows, int64_t cap_nnz,
                        int64_t* max_feature) {
  auto* s = (SvmStream*)h;
  if (s->failed) return -3;
  int64_t rows = 0, used = 0;
  while (rows < max_rows) {
    if (s->prow >= s->pend.y.size()) {
      if (s->eof) break;
      if (!svm_stream_refill(s)) {
        if (s->failed) return -3;
        break;
      }
      continue;
    }
    // take as many whole pending rows as fit the row and nnz caps, then
    // bulk-copy their flat index/value slices
    size_t take = 0;
    int64_t take_nnz = 0;
    while (s->prow + take < s->pend.y.size() &&
           rows + (int64_t)take < max_rows) {
      int64_t n = s->pend.nnz[s->prow + take];
      if (n > cap_nnz) return -2;
      if (used + take_nnz + n > cap_nnz) break;
      take_nnz += n;
      take++;
    }
    if (take == 0) break;  // chunk full by nnz
    memcpy(y + rows, s->pend.y.data() + s->prow, take * sizeof(double));
    memcpy(row_nnz + rows, s->pend.nnz.data() + s->prow,
           take * sizeof(int32_t));
    memcpy(idx + used, s->pend.idx.data() + s->pnz,
           (size_t)take_nnz * sizeof(int32_t));
    memcpy(val + used, s->pend.val.data() + s->pnz,
           (size_t)take_nnz * sizeof(float));
    rows += (int64_t)take;
    used += take_nnz;
    s->prow += take;
    s->pnz += (size_t)take_nnz;
  }
  if (s->prow >= s->pend.y.size() && s->eof) {
    s->pend = SvmFlat();  // release the last window's rows promptly
    s->prow = 0;
    s->pnz = 0;
  }
  *max_feature = s->max_idx + 1;
  return rows;
}

void svm_stream_free(void* h) {
  auto* s = (SvmStream*)h;
  if (s->f) fclose(s->f);
  delete s;
}

// CSV: numeric rectangular parse. Returns handle + dims.
struct CsvFile {
  std::vector<std::vector<double>> rows;
  int64_t n_cols = 0;
};

static void parse_csv_range(const char* data, size_t begin, size_t end,
                            char delim, std::vector<std::vector<double>>* out) {
  size_t pos = begin;
  while (pos < end) {
    size_t eol = pos;
    while (eol < end && data[eol] != '\n') eol++;
    const char* p = data + pos;
    const char* stop = data + eol;
    pos = eol + 1;
    while (p < stop && (*p == ' ' || *p == '\r')) p++;
    if (p >= stop) continue;
    std::vector<double> row;
    while (p < stop) {
      char* next = nullptr;
      double v = strtod(p, &next);
      if (next == p) { // non-numeric cell → NaN, skip to delim
        v = NAN;
        next = (char*)p;
        while (next < stop && *next != delim) next++;
      }
      row.push_back(v);
      p = next;
      while (p < stop && *p != delim) p++;
      if (p < stop) p++;  // skip delim
    }
    if (!row.empty()) out->push_back(std::move(row));
  }
}

void* csv_open(const char* path, char delim, int skip_header, int n_threads,
               int64_t* n_rows, int64_t* n_cols) {
  std::vector<char> buf;
  if (!read_whole(path, &buf)) return nullptr;
  size_t size = buf.size();
  size_t start = 0;
  if (skip_header) {
    while (start < size && buf[start] != '\n') start++;
    if (start < size) start++;
  }
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (size - start < (size_t)(nt * 4096)) nt = 1;
  std::vector<size_t> bounds(nt + 1, start);
  bounds[nt] = size;
  for (int i = 1; i < nt; i++) {
    size_t b = start + (size - start) * i / nt;
    while (b < size && buf[b] != '\n') b++;
    bounds[i] = b < size ? b + 1 : size;
  }
  std::vector<std::vector<std::vector<double>>> parts(nt);
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; i++)
    threads.emplace_back(parse_csv_range, buf.data(), bounds[i], bounds[i + 1],
                         delim, &parts[i]);
  for (auto& t : threads) t.join();
  auto* out = new CsvFile();
  for (auto& p : parts)
    for (auto& r : p) out->rows.push_back(std::move(r));
  int64_t nc = 0;
  for (auto& r : out->rows)
    if ((int64_t)r.size() > nc) nc = (int64_t)r.size();
  out->n_cols = nc;
  *n_rows = (int64_t)out->rows.size();
  *n_cols = nc;
  return out;
}

int csv_fill(void* h, double* x, int64_t n_rows, int64_t n_cols) {
  auto* f = (CsvFile*)h;
  if ((int64_t)f->rows.size() != n_rows) return -1;
  for (int64_t r = 0; r < n_rows; r++) {
    double* row = x + r * n_cols;
    for (int64_t c = 0; c < n_cols; c++)
      row[c] = c < (int64_t)f->rows[r].size() ? f->rows[r][c] : 0.0;
  }
  return 0;
}

void csv_free(void* h) { delete (CsvFile*)h; }

}  // extern "C"
