// matstore.cpp — native matrix store for bigkrls_tpu.
//
// TPU-native replacement for the reference's bigmemory backing-file layer
// (file-backed big.matrix + .desc descriptor files + write.big.matrix /
// read.big.matrix text persistence; see SURVEY.md §2.4 M1 and
// R/bigKRLS_Rcpp_functions.R:105-156).  The reference round-trips N×N
// doubles through *text* files; this writes raw little-endian f64 with a
// trailing xxhash-style checksum, streams with large aligned buffers, and
// exposes mmap-based zero-copy reads for numpy.memmap consumers.
//
// Also provides a fast type-sniffing CSV reader used by the data-loading
// path (utils/io.py) — the replacement for read.big.matrix(text).
//
// Built as a plain shared library; Python binds via ctypes (no pybind11
// in this environment).
//
//   g++ -O3 -march=native -shared -fPIC -o libmatstore.so matstore.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x4B524C535F543130ULL;  // "KRLS_T10"
constexpr size_t kBufBytes = 8u << 20;              // 8 MiB write buffer

// FNV-1a 64-bit over the raw bytes — cheap integrity check replacing
// nothing in the reference (it has none); catches torn writes on resume.
uint64_t fnv1a(const uint8_t* data, size_t n, uint64_t h) {
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= 1099511628211ULL;
  }
  return h;
}

struct Header {
  uint64_t magic;
  uint64_t rows;
  uint64_t cols;
  uint64_t dtype;  // 0 = f64, 1 = f32
};

}  // namespace

extern "C" {

// Write a dense row-major matrix. Returns 0 on success, negative errno-ish
// codes on failure.
int matstore_write(const char* path, const double* data, uint64_t rows,
                   uint64_t cols) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  setvbuf(f, nullptr, _IOFBF, kBufBytes);

  Header h{kMagic, rows, cols, 0};
  if (std::fwrite(&h, sizeof(h), 1, f) != 1) { std::fclose(f); return -2; }

  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(data);
  size_t total = static_cast<size_t>(rows) * cols * sizeof(double);
  uint64_t hash = 14695981039346656037ULL;
  size_t off = 0;
  while (off < total) {
    size_t chunk = total - off < kBufBytes ? total - off : kBufBytes;
    if (std::fwrite(bytes + off, 1, chunk, f) != chunk) {
      std::fclose(f);
      return -3;
    }
    hash = fnv1a(bytes + off, chunk, hash);
    off += chunk;
  }
  if (std::fwrite(&hash, sizeof(hash), 1, f) != 1) { std::fclose(f); return -4; }
  if (std::fclose(f) != 0) return -5;
  return 0;
}

// Read back into caller-allocated buffer; verifies shape and checksum.
// rows/cols are in-out: pass 0,0 to query (fills dims, reads nothing).
int matstore_read(const char* path, double* out, uint64_t* rows,
                  uint64_t* cols) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return -2; }
  size_t fsize = static_cast<size_t>(st.st_size);
  if (fsize < sizeof(Header) + sizeof(uint64_t)) { ::close(fd); return -3; }

  void* map = mmap(nullptr, fsize, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return -4;

  const Header* h = static_cast<const Header*>(map);
  if (h->magic != kMagic || h->dtype != 0) { munmap(map, fsize); return -5; }
  size_t nbytes = static_cast<size_t>(h->rows) * h->cols * sizeof(double);
  if (fsize != sizeof(Header) + nbytes + sizeof(uint64_t)) {
    munmap(map, fsize);
    return -6;
  }
  if (*rows == 0 && *cols == 0) {  // query mode
    *rows = h->rows;
    *cols = h->cols;
    munmap(map, fsize);
    return 0;
  }
  if (*rows != h->rows || *cols != h->cols) { munmap(map, fsize); return -7; }

  const uint8_t* payload =
      static_cast<const uint8_t*>(map) + sizeof(Header);
  uint64_t expect;
  std::memcpy(&expect, payload + nbytes, sizeof(expect));
  uint64_t hash = fnv1a(payload, nbytes, 14695981039346656037ULL);
  if (hash != expect) { munmap(map, fsize); return -8; }

  std::memcpy(out, payload, nbytes);
  munmap(map, fsize);
  return 0;
}

// Header size, so Python can memmap the payload zero-copy after an
// integrity check (data starts at this offset).
int matstore_header_bytes() { return static_cast<int>(sizeof(Header)); }

// ---------------------------------------------------------------------
// Fast CSV reader: parses numeric CSV into a caller buffer.  Pass
// out=nullptr to count rows/cols first.  Handles a single optional header
// line (detected: first field of first line not parseable as a number).
// Returns number of parsed values, or negative on error.
// ---------------------------------------------------------------------
long long matstore_read_csv(const char* path, double* out, long long maxvals,
                            long long* rows, long long* cols,
                            int* has_header) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return -2; }
  size_t fsize = static_cast<size_t>(st.st_size);
  if (fsize == 0) { ::close(fd); return -3; }
  char* map = static_cast<char*>(
      mmap(nullptr, fsize, PROT_READ, MAP_PRIVATE, fd, 0));
  ::close(fd);
  if (map == MAP_FAILED) return -4;

  const char* p = map;
  const char* end = map + fsize;

  // detect header
  {
    char* q;
    std::strtod(p, &q);
    *has_header = (q == p || (*q != ',' && *q != '\n' && *q != '\r' &&
                              *q != '\t' && q != end))
                      ? 1
                      : 0;
  }
  if (*has_header) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }

  long long nvals = 0, nrows = 0, ncols = 0, cur_cols = 0;
  while (p < end) {
    if (*p == '\n' || *p == '\r') {
      if (cur_cols > 0) {
        ++nrows;
        if (ncols == 0) ncols = cur_cols;
        else if (cur_cols != ncols) { munmap(map, fsize); return -5; }
        cur_cols = 0;
      }
      ++p;
      continue;
    }
    char* q;
    double v = std::strtod(p, &q);
    if (q == p) { munmap(map, fsize); return -6; }
    if (out) {
      if (nvals >= maxvals) { munmap(map, fsize); return -7; }
      out[nvals] = v;
    }
    ++nvals;
    ++cur_cols;
    p = q;
    while (p < end && (*p == ',' || *p == ' ' || *p == '\t')) ++p;
  }
  if (cur_cols > 0) {
    ++nrows;
    if (ncols == 0) ncols = cur_cols;
    else if (cur_cols != ncols) { munmap(map, fsize); return -5; }
  }
  *rows = nrows;
  *cols = ncols;
  munmap(map, fsize);
  return nvals;
}

}  // extern "C"
