// Native surface extraction for level-set fields.
//
// The reference visualises surfaces with k3d.marching_cubes inside the
// notebook (cell 10 :785-795, cell 14 :4694-4741); this extension is the
// offline production path: it triangulates the zero level set of a dense
// float32 field via tetrahedral decomposition (6 tets per cube), the same
// scheme as the plain NumPy version in utils/io.py (marching_cubes_plain).
//
// Exposed with a plain C ABI for ctypes.  Thread-free, allocation owned
// by this library; callers must free results with mc_free().

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

inline Vec3 interp(const Vec3& a, const Vec3& b, float fa, float fb) {
  float t = (fa != fb) ? fa / (fa - fb) : 0.5f;
  return {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
          a.z + t * (b.z - a.z)};
}

}  // namespace

extern "C" {

// Returns 0 on success. Outputs: *verts (3 floats per vertex),
// *n_verts, *tris (3 int32 per triangle), *n_tris.
int mc_run(const float* phi, int nx, int ny, int nz, float level,
           float** verts_out, int64_t* n_verts, int32_t** tris_out,
           int64_t* n_tris) {
  std::vector<float> verts;
  std::vector<int32_t> tris;
  verts.reserve(1 << 16);
  tris.reserve(1 << 16);

  auto F = [&](int x, int y, int z) -> float {
    return phi[(int64_t)(x * ny + y) * nz + z] - level;
  };

  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int z = 0; z + 1 < nz; ++z) {
        float cv[8];
        Vec3 cp[8];
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; ++c) {
          cv[c] = F(x + CORNERS[c][0], y + CORNERS[c][1],
                    z + CORNERS[c][2]);
          cp[c] = {float(x + CORNERS[c][0]), float(y + CORNERS[c][1]),
                   float(z + CORNERS[c][2])};
          (cv[c] < 0 ? any_in : any_out) = true;
        }
        if (!any_in || !any_out) continue;

        for (const auto& tet : TETS) {
          float v[4];
          Vec3 p[4];
          int ins[4], outs[4], ni = 0, no = 0;
          for (int k = 0; k < 4; ++k) {
            v[k] = cv[tet[k]];
            p[k] = cp[tet[k]];
            if (v[k] < 0) ins[ni++] = k; else outs[no++] = k;
          }
          if (ni == 0 || ni == 4) continue;

          auto emit_tri = [&](const Vec3& a, const Vec3& b, const Vec3& c) {
            int32_t base = (int32_t)(verts.size() / 3);
            for (const Vec3& q : {a, b, c}) {
              verts.push_back(q.x);
              verts.push_back(q.y);
              verts.push_back(q.z);
            }
            tris.push_back(base);
            tris.push_back(base + 1);
            tris.push_back(base + 2);
          };

          if (ni == 1) {
            int i = ins[0];
            Vec3 q0 = interp(p[i], p[outs[0]], v[i], v[outs[0]]);
            Vec3 q1 = interp(p[i], p[outs[1]], v[i], v[outs[1]]);
            Vec3 q2 = interp(p[i], p[outs[2]], v[i], v[outs[2]]);
            emit_tri(q0, q1, q2);
          } else if (ni == 3) {
            int i = outs[0];
            Vec3 q0 = interp(p[ins[0]], p[i], v[ins[0]], v[i]);
            Vec3 q1 = interp(p[ins[1]], p[i], v[ins[1]], v[i]);
            Vec3 q2 = interp(p[ins[2]], p[i], v[ins[2]], v[i]);
            emit_tri(q0, q1, q2);
          } else {  // 2-2: quad as two triangles
            int i0 = ins[0], i1 = ins[1], o0 = outs[0], o1 = outs[1];
            Vec3 q0 = interp(p[i0], p[o0], v[i0], v[o0]);
            Vec3 q1 = interp(p[i0], p[o1], v[i0], v[o1]);
            Vec3 q2 = interp(p[i1], p[o1], v[i1], v[o1]);
            Vec3 q3 = interp(p[i1], p[o0], v[i1], v[o0]);
            emit_tri(q0, q1, q2);
            int32_t base = (int32_t)(verts.size() / 3) - 3;
            tris.push_back(base);
            tris.push_back(base + 2);
            verts.push_back(q3.x);
            verts.push_back(q3.y);
            verts.push_back(q3.z);
            tris.push_back(base + 3);
          }
        }
      }
    }
  }

  *n_verts = (int64_t)(verts.size() / 3);
  *n_tris = (int64_t)(tris.size() / 3);
  float* vbuf = (float*)std::malloc(verts.size() * sizeof(float));
  int32_t* tbuf = (int32_t*)std::malloc(tris.size() * sizeof(int32_t));
  if ((!vbuf && !verts.empty()) || (!tbuf && !tris.empty())) {
    std::free(vbuf);
    std::free(tbuf);
    return 1;
  }
  if (!verts.empty()) std::memcpy(vbuf, verts.data(), verts.size() * sizeof(float));
  if (!tris.empty()) std::memcpy(tbuf, tris.data(), tris.size() * sizeof(int32_t));
  *verts_out = vbuf;
  *tris_out = tbuf;
  return 0;
}

void mc_free(void* p) { std::free(p); }

}  // extern "C"
