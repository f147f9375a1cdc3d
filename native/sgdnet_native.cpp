// sgdnet_tpu native data layer.
//
// The reference implements its entire core in C++ (reference src/, ~2.1k
// LoC of header-only Eigen templates).  In this framework the *compute*
// path is JAX/XLA on the accelerator, and the native layer instead covers what
// actually belongs off-device: wide-row data ingestion and layout packing
// that feed the padded-CSR device format.  Exposed via a plain C ABI and
// loaded with ctypes (no pybind11 dependency).
//
// Components:
//   * libsvm/svmlight text parser  -> CSR (indptr/indices/values/labels),
//     multithreaded over row chunks
//   * CSR -> padded row-major layout packer (the PaddedCSR device format)
//   * sparse-aware column statistics (mean / population variance counting
//     implicit zeros; reference src/math.h:89-112 semantics)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// libsvm parser
// ---------------------------------------------------------------------------

struct ParseResult {
  int64_t n_rows;
  int64_t n_cols;     // max feature index + 1 (1-based input -> 0-based)
  int64_t nnz;
  int64_t* indptr;    // n_rows + 1
  int32_t* indices;   // nnz
  double* values;     // nnz
  double* labels;     // n_rows
  char* error;        // nullptr on success
};

static char* dup_error(const std::string& msg) {
  char* out = static_cast<char*>(std::malloc(msg.size() + 1));
  std::memcpy(out, msg.c_str(), msg.size() + 1);
  return out;
}

// Parse one chunk of lines [begin, end) of the buffer.
struct ChunkOut {
  std::vector<int64_t> row_nnz;
  std::vector<int32_t> indices;
  std::vector<double> values;
  std::vector<double> labels;
  int32_t max_index = -1;
  int32_t min_index = INT32_MAX;
  std::string error;
};

static void parse_chunk(const char* begin, const char* end, ChunkOut* out) {
  const char* p = begin;
  while (p < end) {
    const char* line_end = static_cast<const char*>(std::memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    // skip empty / comment lines
    while (p < line_end && (*p == ' ' || *p == '\t')) ++p;
    if (p >= line_end || *p == '#') {
      p = line_end + 1;
      continue;
    }
    char* next = nullptr;
    double label = std::strtod(p, &next);
    if (next == p) {
      out->error = "bad label in libsvm line";
      return;
    }
    p = next;
    int64_t nnz_before = static_cast<int64_t>(out->indices.size());
    while (p < line_end) {
      while (p < line_end && (*p == ' ' || *p == '\t')) ++p;
      if (p >= line_end || *p == '#') break;
      char* colon = nullptr;
      long idx = std::strtol(p, &colon, 10);
      if (colon == p || colon >= line_end || *colon != ':') {
        out->error = "bad feature:value pair";
        return;
      }
      p = colon + 1;
      double val = std::strtod(p, &next);
      if (next == p) {
        out->error = "bad feature value";
        return;
      }
      p = next;
      // store raw indices; 0- vs 1-based resolved after the full pass
      // (classic libsvm is 1-based, sklearn dumps 0-based)
      if (idx < 0) {
        out->error = "feature index must be >= 0";
        return;
      }
      int32_t raw = static_cast<int32_t>(idx);
      out->indices.push_back(raw);
      out->values.push_back(val);
      out->max_index = std::max(out->max_index, raw);
      out->min_index = std::min(out->min_index, raw);
    }
    out->labels.push_back(label);
    out->row_nnz.push_back(static_cast<int64_t>(out->indices.size()) - nnz_before);
    p = line_end + 1;
  }
}

ParseResult* sgdnet_parse_libsvm(const char* buf, int64_t len, int32_t n_threads) {
  auto* res = static_cast<ParseResult*>(std::calloc(1, sizeof(ParseResult)));
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  // split the buffer at newline boundaries
  std::vector<const char*> starts{buf};
  const char* end = buf + len;
  for (int t = 1; t < n_threads; ++t) {
    const char* cand = buf + (len * t) / n_threads;
    const char* nl = static_cast<const char*>(std::memchr(cand, '\n', end - cand));
    starts.push_back(nl ? nl + 1 : end);
  }
  std::sort(starts.begin(), starts.end());
  starts.push_back(end);

  std::vector<ChunkOut> chunks(starts.size() - 1);
  std::vector<std::thread> threads;
  for (size_t t = 0; t + 1 < starts.size(); ++t) {
    threads.emplace_back(parse_chunk, starts[t], starts[t + 1], &chunks[t]);
  }
  for (auto& th : threads) th.join();

  int64_t n_rows = 0, nnz = 0;
  int32_t max_index = -1;
  int32_t min_index = INT32_MAX;
  for (auto& c : chunks) {
    if (!c.error.empty()) {
      res->error = dup_error(c.error);
      return res;
    }
    n_rows += static_cast<int64_t>(c.labels.size());
    nnz += static_cast<int64_t>(c.indices.size());
    max_index = std::max(max_index, c.max_index);
    min_index = std::min(min_index, c.min_index);
  }
  // auto-detect 1-based (classic libsvm) vs 0-based (sklearn dumps)
  int32_t shift = (nnz > 0 && min_index >= 1) ? 1 : 0;
  if (shift) {
    for (auto& c : chunks)
      for (auto& ix : c.indices) ix -= 1;
    max_index -= 1;
  }

  res->n_rows = n_rows;
  res->n_cols = max_index + 1;
  res->nnz = nnz;
  res->indptr = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (n_rows + 1)));
  res->indices = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<int64_t>(nnz, 1)));
  res->values = static_cast<double*>(std::malloc(sizeof(double) * std::max<int64_t>(nnz, 1)));
  res->labels = static_cast<double*>(std::malloc(sizeof(double) * std::max<int64_t>(n_rows, 1)));

  int64_t row = 0, pos = 0;
  res->indptr[0] = 0;
  for (auto& c : chunks) {
    std::memcpy(res->labels + row, c.labels.data(), sizeof(double) * c.labels.size());
    std::memcpy(res->indices + pos, c.indices.data(), sizeof(int32_t) * c.indices.size());
    std::memcpy(res->values + pos, c.values.data(), sizeof(double) * c.values.size());
    for (size_t i = 0; i < c.row_nnz.size(); ++i) {
      res->indptr[row + 1] = res->indptr[row] + c.row_nnz[i];
      ++row;
    }
    pos += static_cast<int64_t>(c.indices.size());
  }
  return res;
}

void sgdnet_free_parse_result(ParseResult* r) {
  if (!r) return;
  std::free(r->indptr);
  std::free(r->indices);
  std::free(r->values);
  std::free(r->labels);
  std::free(r->error);
  std::free(r);
}

// ---------------------------------------------------------------------------
// CSR -> padded row-major packer (PaddedCSR device layout)
// ---------------------------------------------------------------------------

// out_indices/out_values must be zero-initialized (n_rows * row_width).
void sgdnet_pack_padded(const int64_t* indptr, const int32_t* indices,
                        const double* values, int64_t n_rows, int64_t row_width,
                        int32_t* out_indices, float* out_values,
                        int32_t* out_nnz, int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t b = indptr[i], e = indptr[i + 1];
      int64_t m = std::min<int64_t>(e - b, row_width);
      out_nnz[i] = static_cast<int32_t>(m);
      int32_t* oi = out_indices + i * row_width;
      float* ov = out_values + i * row_width;
      for (int64_t k = 0; k < m; ++k) {
        oi[k] = indices[b + k];
        ov[k] = static_cast<float>(values[b + k]);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = n_rows * t / n_threads, hi = n_rows * (t + 1) / n_threads;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// sparse column statistics (population variance, zeros counted)
// ---------------------------------------------------------------------------

void sgdnet_csr_column_stats(const int64_t* indptr, const int32_t* indices,
                             const double* values, int64_t n_rows,
                             int64_t n_cols, double* out_mean,
                             double* out_sd) {
  std::vector<double> sum(n_cols, 0.0), sq(n_cols, 0.0);
  int64_t nnz = indptr[n_rows];
  for (int64_t k = 0; k < nnz; ++k) {
    sum[indices[k]] += values[k];
    sq[indices[k]] += values[k] * values[k];
  }
  for (int64_t j = 0; j < n_cols; ++j) {
    double mean = sum[j] / n_rows;
    double var = sq[j] / n_rows - mean * mean;
    if (var < 0) var = 0;
    out_mean[j] = mean;
    // reference src/math.h:108 zero-variance guard
    out_sd[j] = var == 0.0 ? 1.0 : std::sqrt(var);
  }
}

}  // extern "C"
