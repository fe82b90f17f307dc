// Multi-threaded libsvm / CSV text parsers for DMatrix file loading.
//
// The port's own copy of the JAX package's host parser, with the same C
// ABI (xtpu_parse_text / xtpu_parsed_*); the reference's counterpart is
// dmlc-core's data parsers (used by DMatrix::Load, src/data/data.cc, and
// the dense_parser plugin). The file is split at newline boundaries into
// per-thread chunks, each chunk is parsed with hand-rolled number
// scanning (no locale, no strtok), and the per-chunk CSR pieces are
// stitched into one arena. Built for the host by g++
// (ops/cuda/build.py build_host) and loaded through ctypes
// (data/fileio.py _parse_native).

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  std::vector<int64_t> row_nnz;
  std::vector<int32_t> indices;
  std::vector<float> values;
  std::vector<float> labels;
  std::vector<float> qids;
  int32_t max_col = -1;
  bool has_qid = false;
};

struct Parsed {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<float> values;
  std::vector<float> labels;
  std::vector<float> qids;
  int32_t n_cols = 0;
  bool has_qid = false;
};

const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// space-only skip for CSV fields: '\t' may BE the separator (TSV)
const char* skip_sp(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\r')) ++p;
  return p;
}

// locale-independent float scan via std::from_chars (the reference's
// charconv-based parsing, src/common/charconv.cc, exists for the same
// reason: strtof honours LC_NUMERIC and breaks on comma-decimal locales)
const char* scan_float(const char* p, const char* end, float* out) {
  auto res = std::from_chars(p, end, *out);
  if (res.ec != std::errc()) {
    *out = NAN;
    return p;
  }
  return res.ptr;
}

void parse_libsvm_chunk(const char* beg, const char* end, Chunk* out) {
  const char* p = beg;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    p = skip_ws(p, line_end);
    if (p < line_end && *p != '#') {
      float label;
      p = scan_float(p, line_end, &label);
      out->labels.push_back(label);
      int64_t nnz = 0;
      float qid = 0.0f;
      while (true) {
        p = skip_ws(p, line_end);
        if (p >= line_end || *p == '#') break;
        if (line_end - p > 4 && memcmp(p, "qid:", 4) == 0) {
          p = scan_float(p + 4, line_end, &qid);
          out->has_qid = true;
          continue;
        }
        long idx = 0;
        auto ires = std::from_chars(p, line_end, idx);
        const char* q = ires.ptr;
        if (ires.ec != std::errc() || q >= line_end || *q != ':')
          break;  // malformed tail
        float val;
        p = scan_float(q + 1, line_end, &val);
        out->indices.push_back(static_cast<int32_t>(idx));
        out->values.push_back(val);
        if (idx > out->max_col) out->max_col = static_cast<int32_t>(idx);
        ++nnz;
      }
      out->row_nnz.push_back(nnz);
      out->qids.push_back(qid);
    }
    p = line_end + 1;
  }
}

void parse_csv_chunk(const char* beg, const char* end, char sep, Chunk* out) {
  const char* p = beg;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    p = skip_ws(p, line_end);
    if (p < line_end && *p != '#') {
      int64_t nnz = 0;
      int32_t col = 0;
      while (true) {  // one field per pass; trailing 'sep' emits an empty
        p = skip_sp(p, line_end);
        float val = NAN;
        if (p < line_end && *p != sep) p = scan_float(p, line_end, &val);
        out->indices.push_back(col);
        out->values.push_back(val);
        ++nnz;
        if (col > out->max_col) out->max_col = col;
        ++col;
        p = skip_sp(p, line_end);
        if (p < line_end && *p == sep) {
          ++p;
          continue;
        }
        break;
      }
      out->row_nnz.push_back(nnz);
      out->labels.push_back(0.0f);
      out->qids.push_back(0.0f);
    }
    p = line_end + 1;
  }
}

Parsed* parse_file(const char* path, bool csv, char sep, int nthreads) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[size] = '\0';

  if (nthreads <= 0)
    nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (size < (1 << 20)) nthreads = 1;  // small file: thread spawn not worth it

  // chunk boundaries snapped forward to the next newline
  std::vector<const char*> bounds(nthreads + 1);
  const char* base = buf.data();
  bounds[0] = base;
  bounds[nthreads] = base + size;
  for (int t = 1; t < nthreads; ++t) {
    const char* p = base + size * t / nthreads;
    while (p < base + size && *p != '\n') ++p;
    bounds[t] = (p < base + size) ? p + 1 : base + size;
  }

  std::vector<Chunk> chunks(nthreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      if (csv)
        parse_csv_chunk(bounds[t], bounds[t + 1], sep, &chunks[t]);
      else
        parse_libsvm_chunk(bounds[t], bounds[t + 1], &chunks[t]);
    });
  }
  for (auto& th : threads) th.join();

  auto* out = new Parsed();
  int64_t rows = 0, nnz = 0;
  for (auto& c : chunks) {
    rows += static_cast<int64_t>(c.row_nnz.size());
    nnz += static_cast<int64_t>(c.values.size());
    if (c.max_col + 1 > out->n_cols) out->n_cols = c.max_col + 1;
    out->has_qid = out->has_qid || c.has_qid;
  }
  out->indptr.reserve(rows + 1);
  out->indices.reserve(nnz);
  out->values.reserve(nnz);
  out->labels.reserve(rows);
  out->qids.reserve(rows);
  out->indptr.push_back(0);
  for (auto& c : chunks) {
    for (int64_t k : c.row_nnz)
      out->indptr.push_back(out->indptr.back() + k);
    out->indices.insert(out->indices.end(), c.indices.begin(),
                        c.indices.end());
    out->values.insert(out->values.end(), c.values.begin(), c.values.end());
    out->labels.insert(out->labels.end(), c.labels.begin(), c.labels.end());
    out->qids.insert(out->qids.end(), c.qids.begin(), c.qids.end());
  }
  return out;
}

}  // namespace

extern "C" {

void* xtpu_parse_text(const char* path, int csv, char sep, int nthreads) {
  return parse_file(path, csv != 0, sep, nthreads);
}

int64_t xtpu_parsed_rows(void* h) {
  return static_cast<int64_t>(
      static_cast<Parsed*>(h)->indptr.size()) - 1;
}

int64_t xtpu_parsed_nnz(void* h) {
  return static_cast<int64_t>(static_cast<Parsed*>(h)->values.size());
}

int32_t xtpu_parsed_cols(void* h) { return static_cast<Parsed*>(h)->n_cols; }

int32_t xtpu_parsed_has_qid(void* h) {
  return static_cast<Parsed*>(h)->has_qid ? 1 : 0;
}

void xtpu_parsed_fill(void* h, int64_t* indptr, int32_t* indices,
                      float* values, float* labels, float* qids) {
  auto* p = static_cast<Parsed*>(h);
  memcpy(indptr, p->indptr.data(), p->indptr.size() * sizeof(int64_t));
  memcpy(indices, p->indices.data(), p->indices.size() * sizeof(int32_t));
  memcpy(values, p->values.data(), p->values.size() * sizeof(float));
  memcpy(labels, p->labels.data(), p->labels.size() * sizeof(float));
  memcpy(qids, p->qids.data(), p->qids.size() * sizeof(float));
}

void xtpu_parsed_free(void* h) { delete static_cast<Parsed*>(h); }

}  // extern "C"
