// Fast CrystFEL .stream parser.
//
// Native data-loader for the PyTorch port of careless-tpu: the JAX
// package's cpp/stream_parser.cc with the same parse and the same double
// arithmetic (the reference delegates this to reciprocalspaceship's
// pure-Python parser; serial-crystallography streams run to many
// gigabytes, so the loader is a real bottleneck there).
// Single pass over an mmap'd file; emits flat arrays copied into numpy via
// ctypes (careless_tpu_torch/xtal/_native.py, which also builds this file
// at its first use).
//
// Geometry matches the Python reader of careless_tpu_torch/xtal/stream.py:
//   A* rows from astar/bstar/cstar (nm^-1 -> 1/A), svec = hkl @ A*,
//   s1 = svec + (0,0,1/lambda), ewald_offset = |s1| - 1/lambda,
//   angular offset = degrees(asin(eo/|s1|)).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr double kHcEvA = 12398.419843320026;

struct StreamData {
  std::vector<int32_t> hkl;     // n x 3
  std::vector<float> cols;      // n x 11: I SigI batch s1x s1y s1z eo aeo fs ss lam
  double cell[6];
  bool has_cell = false;
  std::string error;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  return p;
}

// parse a double, advancing p; returns false if no number found
inline bool parse_num(const char*& p, const char* end, double* out) {
  p = skip_ws(p, end);
  char* q;
  double v = strtod(p, &q);
  if (q == p) return false;
  *out = v;
  p = q;
  return true;
}

inline bool starts_with(const char* p, const char* end, const char* s) {
  size_t n = strlen(s);
  return static_cast<size_t>(end - p) >= n && memcmp(p, s, n) == 0;
}

}  // namespace

extern "C" {

StreamData* stream_parse(const char* path) {
  auto* out = new StreamData();
  int fd = open(path, O_RDONLY);
  if (fd < 0) {
    out->error = std::string("cannot open ") + path;
    return out;
  }
  struct stat st;
  fstat(fd, &st);
  size_t size = st.st_size;
  const char* data =
      static_cast<const char*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) {
    out->error = std::string("mmap failed for ") + path;
    return out;
  }

  const char* p = data;
  const char* end = data + size;

  double astar[3] = {0, 0, 0}, bstar[3] = {0, 0, 0}, cstar[3] = {0, 0, 0};
  double lambda = 0.0;
  double photon_energy = 0.0;
  int32_t batch = -1;
  bool in_refls = false;
  bool in_header_cell = false;
  bool cell_done = false;

  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;

    if (in_refls) {
      // hot path: "   h    k    l          I   sigma(I)  peak  bg  fs ss panel"
      if (starts_with(p, line_end, "End of reflections")) {
        in_refls = false;
      } else {
        const char* q = p;
        double h, k, l, I, sigI, peak, bg, fs, ss;
        if (parse_num(q, line_end, &h) && parse_num(q, line_end, &k) &&
            parse_num(q, line_end, &l) && parse_num(q, line_end, &I) &&
            parse_num(q, line_end, &sigI) && parse_num(q, line_end, &peak) &&
            parse_num(q, line_end, &bg) && parse_num(q, line_end, &fs) &&
            parse_num(q, line_end, &ss)) {
          double sx = h * astar[0] + k * bstar[0] + l * cstar[0];
          double sy = h * astar[1] + k * bstar[1] + l * cstar[1];
          double sz = h * astar[2] + k * bstar[2] + l * cstar[2];
          double k0 = 1.0 / lambda;
          double s1x = sx, s1y = sy, s1z = sz + k0;
          double s1n = sqrt(s1x * s1x + s1y * s1y + s1z * s1z);
          double eo = s1n - k0;
          double r = eo / s1n;
          if (r > 1.0) r = 1.0;
          if (r < -1.0) r = -1.0;
          double aeo = asin(r) * 57.29577951308232;
          out->hkl.push_back(static_cast<int32_t>(h));
          out->hkl.push_back(static_cast<int32_t>(k));
          out->hkl.push_back(static_cast<int32_t>(l));
          float row[11] = {
              static_cast<float>(I),   static_cast<float>(sigI),
              static_cast<float>(batch), static_cast<float>(s1x),
              static_cast<float>(s1y), static_cast<float>(s1z),
              static_cast<float>(eo),  static_cast<float>(aeo),
              static_cast<float>(fs),  static_cast<float>(ss),
              static_cast<float>(lambda)};
          out->cols.insert(out->cols.end(), row, row + 11);
        }
      }
    } else if (starts_with(p, line_end, "Reflections measured after indexing")) {
      in_refls = true;
      lambda = kHcEvA / photon_energy;
      // skip the column-header line that follows
      if (nl) {
        const char* nl2 =
            static_cast<const char*>(memchr(nl + 1, '\n', end - nl - 1));
        p = nl2 ? nl2 + 1 : end;
        continue;
      }
    } else if (starts_with(p, line_end, "--- Begin crystal")) {
      ++batch;
    } else if (starts_with(p, line_end, "astar =")) {
      const char* q = p + 7;
      for (double& v : astar) { parse_num(q, line_end, &v); v /= 10.0; }
    } else if (starts_with(p, line_end, "bstar =")) {
      const char* q = p + 7;
      for (double& v : bstar) { parse_num(q, line_end, &v); v /= 10.0; }
    } else if (starts_with(p, line_end, "cstar =")) {
      const char* q = p + 7;
      for (double& v : cstar) { parse_num(q, line_end, &v); v /= 10.0; }
    } else if (starts_with(p, line_end, "photon_energy_eV")) {
      const char* q = static_cast<const char*>(memchr(p, '=', line_end - p));
      if (q) { ++q; parse_num(q, line_end, &photon_energy); }
    } else if (starts_with(p, line_end, "----- Begin unit cell")) {
      in_header_cell = true;
    } else if (starts_with(p, line_end, "----- End unit cell")) {
      in_header_cell = false;
      cell_done = true;
    } else if (in_header_cell && !cell_done) {
      const char* q = skip_ws(p, line_end);
      static const char* keys[6] = {"a =", "b =", "c =", "al =", "be =", "ga ="};
      for (int i = 0; i < 6; ++i) {
        if (starts_with(q, line_end, keys[i])) {
          const char* r = q + strlen(keys[i]);
          double v;
          if (parse_num(r, line_end, &v)) {
            // lengths may be quoted in nm or A; CrystFEL cell files use A
            out->cell[i] = v;
            out->has_cell = true;
          }
          break;
        }
      }
    }

    if (!nl) break;
    p = nl + 1;
  }

  munmap(const_cast<char*>(data), size);
  if (out->hkl.empty()) {
    out->error = std::string(path) + ": no indexed reflections found";
  }
  return out;
}

int64_t stream_n_refl(StreamData* s) { return s->hkl.size() / 3; }
const int32_t* stream_hkl(StreamData* s) { return s->hkl.data(); }
const float* stream_cols(StreamData* s) { return s->cols.data(); }
const double* stream_cell(StreamData* s) {
  return s->has_cell ? s->cell : nullptr;
}
const char* stream_error(StreamData* s) {
  return s->error.empty() ? nullptr : s->error.c_str();
}
void stream_free(StreamData* s) { delete s; }

}  // extern "C"
