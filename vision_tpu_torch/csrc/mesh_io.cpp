// Wavefront OBJ parsing for the port's host library (`vision_tpu_torch/native.py`).
//
// The same parser as `native/mesh_io.cpp` `vt_load_obj` (v / vt / vn / f,
// negative indices, polygons fan-triangulated, one output vertex per
// distinct v/vt/vn triple), with one difference: the vertex cache keys on
// the exact index triple. The packed 64-bit key of the original,
// (vi+1)<<42 ^ (ti+2)<<21 ^ (ni+2), wraps past 2^22 positions and lets the
// uv field spill into the position field past 2^21 - 2 uvs, so a later
// vertex could take an earlier one's index. Here the key is two 64-bit
// words that hold the three indices whole.
//
// C ABI, bound with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

struct MeshBlob {
  float *positions;   // [n_verts * 3]
  float *normals;     // [n_verts * 3]
  float *uvs;         // [n_verts * 2]
  int32_t *triangles; // [n_tris * 3]
  int64_t n_verts;
  int64_t n_tris;
};

// The cache key of a vertex: out[0] = vi, out[1] = (ti + 1) << 32 | (ni + 1).
// Exact for vi in [0, 2^64) and ti, ni in [-1, 2^32 - 1).
void vt_obj_key(int64_t vi, int64_t ti, int64_t ni, uint64_t *out) {
  out[0] = (uint64_t)vi;
  out[1] = ((uint64_t)(ti + 1) << 32) | (uint64_t)(uint32_t)(ni + 1);
}

}  // extern "C"

namespace {

struct Key {
  uint64_t a, b;
  bool operator==(const Key &o) const { return a == o.a && b == o.b; }
};

struct KeyHash {
  size_t operator()(const Key &k) const {
    return std::hash<uint64_t>()(k.a * 0x9E3779B97F4A7C15ull ^ k.b);
  }
};

inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char *parse_float(const char *p, float *out) {
  char *q;
  *out = strtof(p, &q);
  return q;
}

// Parse a "v/vt/vn" index triple (vt and vn optional); 0-based out, -1 absent.
inline const char *parse_index(const char *p, const char *end, int64_t nv,
                               int64_t nt, int64_t nn, int64_t *vi,
                               int64_t *ti, int64_t *ni) {
  char *q;
  long v = strtol(p, &q, 10);
  *vi = v > 0 ? v - 1 : nv + v;
  *ti = -1;
  *ni = -1;
  p = q;
  if (p < end && *p == '/') {
    ++p;
    if (*p != '/') {
      long t = strtol(p, &q, 10);
      *ti = t > 0 ? t - 1 : nt + t;
      p = q;
    }
    if (p < end && *p == '/') {
      ++p;
      long n = strtol(p, &q, 10);
      *ni = n > 0 ? n - 1 : nn + n;
      p = q;
    }
  }
  return p;
}

template <typename T>
T *copy_out(const std::vector<T> &v) {
  T *out = (T *)malloc(v.size() * sizeof(T) + 1);
  if (!v.empty()) memcpy(out, v.data(), v.size() * sizeof(T));
  return out;
}

}  // namespace

extern "C" {

// Returns 0, -1 when the file cannot be opened, -2 when it cannot be read.
int32_t vt_load_obj(const char *path, MeshBlob *out) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return -2;
  }
  fclose(f);

  std::vector<float> vs, vts, vns;
  std::vector<float> opos, onrm, ouv;
  std::vector<int32_t> tris;
  std::unordered_map<Key, int32_t, KeyHash> cache;
  cache.reserve(1 << 16);

  const char *p = buf.data();
  const char *end = p + buf.size();
  std::vector<int32_t> face;

  while (p < end) {
    const char *line_end = static_cast<const char *>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char *lp = skip_ws(p, line_end);
    if (lp + 1 < line_end && lp[0] == 'v' && lp[1] == ' ') {
      float x, y, z;
      lp = parse_float(lp + 2, &x);
      lp = parse_float(lp, &y);
      lp = parse_float(lp, &z);
      vs.push_back(x); vs.push_back(y); vs.push_back(z);
    } else if (lp + 2 < line_end && lp[0] == 'v' && lp[1] == 't' && lp[2] == ' ') {
      float u, v;
      lp = parse_float(lp + 3, &u);
      lp = parse_float(lp, &v);
      vts.push_back(u); vts.push_back(v);
    } else if (lp + 2 < line_end && lp[0] == 'v' && lp[1] == 'n' && lp[2] == ' ') {
      float x, y, z;
      lp = parse_float(lp + 3, &x);
      lp = parse_float(lp, &y);
      lp = parse_float(lp, &z);
      vns.push_back(x); vns.push_back(y); vns.push_back(z);
    } else if (lp + 1 < line_end && lp[0] == 'f' && lp[1] == ' ') {
      face.clear();
      lp += 2;
      int64_t nv = (int64_t)vs.size() / 3;
      int64_t nt = (int64_t)vts.size() / 2;
      int64_t nn = (int64_t)vns.size() / 3;
      while (lp < line_end) {
        lp = skip_ws(lp, line_end);
        if (lp >= line_end || *lp == '\n' || *lp == '#') break;
        int64_t vi, ti, ni;
        const char *np = parse_index(lp, line_end, nv, nt, nn, &vi, &ti, &ni);
        if (np == lp) break;
        lp = np;
        if (vi < 0 || vi >= nv) continue;
        uint64_t k[2];
        vt_obj_key(vi, ti, ni, k);
        auto it = cache.find(Key{k[0], k[1]});
        int32_t idx;
        if (it != cache.end()) {
          idx = it->second;
        } else {
          idx = (int32_t)(opos.size() / 3);
          opos.insert(opos.end(), &vs[vi * 3], &vs[vi * 3] + 3);
          if (ni >= 0 && ni < nn) {
            onrm.insert(onrm.end(), &vns[ni * 3], &vns[ni * 3] + 3);
          } else {
            onrm.insert(onrm.end(), 3, 0.0f);
          }
          if (ti >= 0 && ti < nt) {
            ouv.insert(ouv.end(), &vts[ti * 2], &vts[ti * 2] + 2);
          } else {
            ouv.insert(ouv.end(), 2, 0.0f);
          }
          cache.emplace(Key{k[0], k[1]}, idx);
        }
        face.push_back(idx);
      }
      for (size_t k = 1; k + 1 < face.size(); ++k) {
        tris.push_back(face[0]);
        tris.push_back(face[k]);
        tris.push_back(face[k + 1]);
      }
    }
    p = line_end + 1;
  }

  out->n_verts = (int64_t)opos.size() / 3;
  out->n_tris = (int64_t)tris.size() / 3;
  out->positions = copy_out(opos);
  out->normals = copy_out(onrm);
  out->uvs = copy_out(ouv);
  out->triangles = copy_out(tris);
  return 0;
}

void vt_free_mesh(MeshBlob *m) {
  free(m->positions);
  free(m->normals);
  free(m->uvs);
  free(m->triangles);
  memset(m, 0, sizeof(*m));
}

}  // extern "C"
