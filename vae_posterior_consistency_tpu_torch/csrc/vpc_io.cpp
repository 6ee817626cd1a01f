// vpc_io — the native host-side data plane of the PyTorch/CUDA port
// (vae_posterior_consistency_tpu_torch), the port's own copy of the JAX
// package's native/vpc_io.cpp: the same functions, the same ABI version,
// the same bits.
//
// The reference's host data path is pandas/numpy/torch Python IO
// (reference: src/utils/loaders.py:319-384). This library provides the
// framework's native ingestion/codec layer:
//
//   * vpc_csv_count / vpc_csv_parse — single-pass float32 CSV reader
//     (the UCI split-index CSVs)
//   * vpc_pack_mask / vpc_unpack_mask — bit-packed observation-mask codec
//     (8x smaller artifacts)
//   * vpc_mcar_mask — xorshift128+ MCAR mask sampling for offline artifact
//     generation (training masks are drawn on the card, ops/masks.py)
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency). Host code:
// built at first use by data/native_io.py with g++ -O3 -shared.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ABI version — bump whenever any exported signature changes. The Python
// loader refuses a binary whose version doesn't match (a stale pre-change
// .so would otherwise be called with the wrong argument list and silently
// misbehave, e.g. dropping the ragged-CSV check).
int64_t vpc_io_abi_version(void) { return 3; }

// ---------------------------------------------------------------------------
// CSV ingestion
// ---------------------------------------------------------------------------

// Count rows/cols of a numeric CSV. Returns 0 on success.
int vpc_csv_count(const char* path, int64_t* rows, int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  int64_t r = 0, c = 0, cur_c = 0;
  bool in_field = false, first_row = true;
  int ch;
  while ((ch = std::fgetc(f)) != EOF) {
    if (ch == ',') {
      ++cur_c;
      in_field = false;
    } else if (ch == '\n') {
      if (in_field || cur_c > 0) {
        ++r;
        if (first_row) {
          c = cur_c + 1;
          first_row = false;
        }
      }
      cur_c = 0;
      in_field = false;
    } else if (ch != '\r' && ch != ' ' && ch != '\t') {
      in_field = true;
    }
  }
  if (in_field || cur_c > 0) {
    ++r;
    if (first_row) c = cur_c + 1;
  }
  std::fclose(f);
  *rows = r;
  *cols = c;
  return 0;
}

// Parse a numeric CSV into a pre-allocated float32 buffer (row-major).
// Every data row must have exactly `cols` values (the width vpc_csv_count
// reported from the first row) — a ragged row would silently column-shift
// everything after it, so it is a hard error.
// Returns the number of values written, -1 on IO error, or -(2+row) when
// data row `row` (0-based) is ragged.
int64_t vpc_csv_parse(const char* path, float* out, int64_t capacity,
                      int64_t cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // read whole file
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(sz + 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  size_t got = std::fread(buf, 1, sz, f);
  std::fclose(f);
  buf[got] = '\0';

  int64_t n = 0, row = 0, row_vals = 0;
  char* p = buf;
  while (*p) {
    if (*p == '\n') {
      if (row_vals > 0) {
        if (cols > 0 && row_vals != cols) {
          std::free(buf);
          return -(2 + row);
        }
        ++row;
        row_vals = 0;
      }
      ++p;
      continue;
    }
    if (*p == ',' || *p == '\r' || *p == ' ' || *p == '\t') {
      ++p;
      continue;
    }
    char* end = nullptr;
    float v = std::strtof(p, &end);
    // A token only counts if strtof consumed ALL of it: a partially-numeric
    // cell ("3.1.4", "12abc") is corruption, not a value — skipping it makes
    // the row ragged, so the error below fires (the numpy fallback raises on
    // the same file; silent truncation would differ by host toolchain).
    bool full_token = end != p;
    for (char* q = end; full_token; ++q) {
      if (*q == '\0' || *q == ',' || *q == '\n' || *q == '\r' || *q == ' ' ||
          *q == '\t')
        break;
      full_token = false;
    }
    if (!full_token) {  // non-numeric or corrupted token: skip, don't count
      while (*p && *p != ',' && *p != '\n') ++p;
      continue;
    }
    if (n == capacity) {
      // more values than rows*cols: a final row wider than the header
      // (mid-file wide rows already hit the ragged check) — hard error,
      // not silent truncation
      std::free(buf);
      return -(2 + row);
    }
    out[n++] = v;
    ++row_vals;
    p = end;
  }
  if (row_vals > 0 && cols > 0 && row_vals != cols) {
    std::free(buf);
    return -(2 + row);
  }
  std::free(buf);
  return n;
}

// ---------------------------------------------------------------------------
// Bit-packed mask codec
// ---------------------------------------------------------------------------

// Pack a float32 0/1 mask into bits (LSB-first). out must hold (n+7)/8 bytes.
void vpc_pack_mask(const float* mask, int64_t n, uint8_t* out) {
  int64_t nbytes = (n + 7) / 8;
  std::memset(out, 0, nbytes);
  for (int64_t i = 0; i < n; ++i) {
    if (mask[i] != 0.0f) out[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
  }
}

// Unpack bits back to float32 0/1.
void vpc_unpack_mask(const uint8_t* packed, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = (packed[i >> 3] >> (i & 7)) & 1u ? 1.0f : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Offline MCAR sampling (xorshift128+)
// ---------------------------------------------------------------------------

// Fill out[n] with Bernoulli(1 - missing_rate/100) floats.
void vpc_mcar_mask(int64_t n, double missing_rate, uint64_t seed, float* out) {
  uint64_t s0 = seed ^ 0x9E3779B97F4A7C15ull;
  uint64_t s1 = (seed << 1) | 1ull;
  const double keep = 1.0 - missing_rate / 100.0;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    uint64_t r = s1 + y;
    double u = (r >> 11) * (1.0 / 9007199254740992.0);  // [0,1)
    out[i] = u < keep ? 1.0f : 0.0f;
  }
}

}  // extern "C"
