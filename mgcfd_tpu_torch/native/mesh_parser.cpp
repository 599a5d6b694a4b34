// The reference's ASCII mesh files parsed in C++ for mgcfd_tpu_torch: a
// copy of mgcfd_tpu/native/mesh_parser.cpp (the port imports nothing of
// mgcfd_tpu), with one change. A neighbour id below -2 is emitted as an
// internal edge, as the Python reader (mesh/io_dat.py) emits it, so that
// the reader's validation refuses the level in both paths.
//
// read_grid's semantics (io.cpp:56-137): node / degree / neighbour-weight
// records, an edge emitted at the larger endpoint, -1 a far-field boundary
// face, -2 a wall face, internal normals negated and, for FVCORR, boundary
// and wall normals too. One pass over the file read into memory with
// strtod/strtoll; C interface, loaded with ctypes (native/loader.py), which
// copies the arrays out and frees them with mgcfd_free_mesh.
//
// Build: g++ -O3 -shared -fPIC mesh_parser.cpp -o libmgcfd_torch_native.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Last parse error (reference error ergonomics: io.cpp:43-47 prints a
// reason and exits; we surface the reason to Python, which raises).
static char g_err[512] = "";
const char* mgcfd_last_error() { return g_err; }

struct ParsedMesh {
  int64_t num_nodes = 0;
  int64_t num_internal = 0;
  int64_t num_boundary = 0;
  int64_t num_wall = 0;
  double* volumes = nullptr;       // [num_nodes]
  int32_t* edge_a = nullptr;       // [num_internal]
  int32_t* edge_b = nullptr;
  double* edge_w = nullptr;        // [num_internal*3]
  int32_t* bedge_b = nullptr;      // [num_boundary]
  double* bedge_w = nullptr;
  int32_t* wedge_b = nullptr;      // [num_wall]
  double* wedge_w = nullptr;
  int64_t claimed_edges = 0;       // header's edge count (for the
                                   // io.cpp:145-147 mismatch warning)
};

// ---------------------------------------------------------------------
// tokenizer: whitespace-separated doubles/ints over a file buffer
// ---------------------------------------------------------------------
namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;

  // a number must fill its whole token ("1.5" is no int, "2x" no number),
  // as the Python reader's int() and float() ask
  bool at_token_end(const char* q) const {
    return q >= end || *q == ' ' || *q == '\n' || *q == '\r' || *q == '\t';
  }
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' ||
                       *p == '\t')) {
      ++p;
    }
  }
  double next_double() {
    skip_ws();
    if (p >= end) { ok = false; return 0.0; }
    char* out = nullptr;
    double v = strtod(p, &out);
    if (out == p || !at_token_end(out)) { ok = false; return 0.0; }
    p = out;
    return v;
  }
  int64_t next_int() {
    skip_ws();
    if (p >= end) { ok = false; return 0; }
    char* out = nullptr;
    long long v = strtoll(p, &out, 10);
    if (out == p || !at_token_end(out)) { ok = false; return 0; }
    p = out;
    return (int64_t)v;
  }
};

char* read_file(const char* path, size_t* len) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(sz + 1);
  if (!buf) { fclose(f); return nullptr; }
  size_t got = fread(buf, 1, sz, f);
  fclose(f);
  if ((long)got != sz) { free(buf); return nullptr; }
  buf[sz] = '\0';
  *len = sz;
  return buf;
}

}  // namespace

// Parse a .dat mesh. flip_all != 0 reproduces the FVCORR rule (every
// normal negated); otherwise only internal normals are negated.
// Returns a heap-allocated ParsedMesh* (free with mgcfd_free_mesh), or
// nullptr on error.
ParsedMesh* mgcfd_parse_dat(const char* path, int flip_all) {
  g_err[0] = 0;
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) {
    snprintf(g_err, sizeof g_err, "%s: cannot read file", path);
    return nullptr;
  }
  Cursor c{buf, buf + len};

  int64_t nel = c.next_int();
  int64_t claimed_edges = c.next_int();
  if (!c.ok) {
    snprintf(g_err, sizeof g_err,
             "%s: missing 'nel num_edges' header", path);
    free(buf); return nullptr;
  }
  if (nel <= 0) {
    snprintf(g_err, sizeof g_err,
             "%s: non-positive node count %lld", path, (long long)nel);
    free(buf); return nullptr;
  }

  auto* m = new ParsedMesh();
  m->num_nodes = nel;
  m->volumes = (double*)malloc(nel * sizeof(double));

  int64_t cap = claimed_edges > 0 ? claimed_edges : 1024;
  std::vector<int32_t> ia, ib, bb, wb;
  std::vector<double> iw, bw, ww;
  ia.reserve(cap); ib.reserve(cap); iw.reserve(cap * 3);

  const double flip_i = -1.0;                 // internal always flipped
  const double flip_bw = flip_all ? -1.0 : 1.0;

  int64_t fail_node = -1;
  bool neg_degree = false;
  for (int64_t i = 0; i < nel && c.ok; ++i) {
    m->volumes[i] = c.next_double();
    int64_t degree = c.next_int();
    if (c.ok && degree < 0) {
      neg_degree = true;
      fail_node = i;
      break;
    }
    if (!c.ok) fail_node = i;
    for (int64_t j = 0; j < degree && c.ok; ++j) {
      int64_t nb = c.next_int();
      double wx = c.next_double();
      double wy = c.next_double();
      double wz = c.next_double();
      if (!c.ok) { fail_node = i; break; }
      if (nb >= i) continue;  // emitted at the larger endpoint only
      if (nb == -1) {
        bb.push_back((int32_t)i);
        bw.push_back(flip_bw * wx);
        bw.push_back(flip_bw * wy);
        bw.push_back(flip_bw * wz);
      } else if (nb == -2) {
        wb.push_back((int32_t)i);
        ww.push_back(flip_bw * wx);
        ww.push_back(flip_bw * wy);
        ww.push_back(flip_bw * wz);
      } else {
        // any other id, below -2 included, as the Python reader takes it
        ia.push_back((int32_t)nb);
        ib.push_back((int32_t)i);
        iw.push_back(flip_i * wx);
        iw.push_back(flip_i * wy);
        iw.push_back(flip_i * wz);
      }
    }
  }
  free(buf);
  if (!c.ok || neg_degree) {
    if (fail_node < 0) fail_node = nel - 1;
    snprintf(g_err, sizeof g_err,
             neg_degree
                 ? "%s: negative degree at node %lld"
                 : "%s: truncated or non-numeric record at node %lld",
             path, (long long)fail_node);
    free(m->volumes);
    delete m;
    return nullptr;
  }
  m->claimed_edges = claimed_edges;

  auto take_i32 = [](std::vector<int32_t>& v) {
    auto* p = (int32_t*)malloc((v.size() ? v.size() : 1)
                               * sizeof(int32_t));
    memcpy(p, v.data(), v.size() * sizeof(int32_t));
    return p;
  };
  auto take_f64 = [](std::vector<double>& v) {
    auto* p = (double*)malloc((v.size() ? v.size() : 1) * sizeof(double));
    memcpy(p, v.data(), v.size() * sizeof(double));
    return p;
  };

  m->num_internal = (int64_t)ia.size();
  m->num_boundary = (int64_t)bb.size();
  m->num_wall = (int64_t)wb.size();
  m->edge_a = take_i32(ia);
  m->edge_b = take_i32(ib);
  m->edge_w = take_f64(iw);
  m->bedge_b = take_i32(bb);
  m->bedge_w = take_f64(bw);
  m->wedge_b = take_i32(wb);
  m->wedge_w = take_f64(ww);
  return m;
}

// Parse an N x 3 whitespace-separated coords sidecar into caller memory.
int mgcfd_parse_coords(const char* path, double* out, int64_t n) {
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return -1;
  Cursor c{buf, buf + len};
  for (int64_t i = 0; i < 3 * n; ++i) out[i] = c.next_double();
  c.skip_ws();
  // exactly n rows, as the Python reader's reshape(n, 3) asks
  int rc = c.ok && c.p == c.end ? 0 : -1;
  free(buf);
  return rc;
}

// Parse an mg-connectivity file (count then `count` int64 ids).
// First call with out == nullptr to get the count.
int64_t mgcfd_parse_mg(const char* path, int64_t* out, int64_t capacity) {
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return -1;
  Cursor c{buf, buf + len};
  int64_t count = c.next_int();
  if (!c.ok) { free(buf); return -1; }
  if (out != nullptr) {
    if (capacity < count) { free(buf); return -1; }
    for (int64_t i = 0; i < count; ++i) out[i] = c.next_int();
    if (!c.ok) { free(buf); return -1; }
  }
  free(buf);
  return count;
}

void mgcfd_free_mesh(ParsedMesh* m) {
  if (!m) return;
  free(m->volumes);
  free(m->edge_a); free(m->edge_b); free(m->edge_w);
  free(m->bedge_b); free(m->bedge_w);
  free(m->wedge_b); free(m->wedge_w);
  delete m;
}

}  // extern "C"
