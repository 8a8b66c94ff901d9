// Native data-loading core: COLMAP binary parsers + Gaussian PLY codec.
//
// Host-side counterpart of the reference's native Swift loaders
// (Data/ColmapDataLoader.swift:188-434, Data/PlyWriter.swift:20-266).  The
// Python fallbacks in gaussiansplattingmlx_tpu/data/ are semantically
// identical; this library exists because COLMAP points3D/images parsing is a
// per-record variable-length walk that Python executes ~100x slower on
// million-point scenes.  Exposed via a C ABI for ctypes (no pybind11 in the
// build image).
//
// Build: scripts/build_native.sh  ->  native/libgsplat_io.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T read() {
    if (p + sizeof(T) > end) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  void skip(size_t n) {
    if (p + n > end) {
      ok = false;
      return;
    }
    p += n;
  }

  // NUL-terminated string.
  std::string read_string() {
    const uint8_t* q = p;
    while (q < end && *q != 0) q++;
    if (q >= end) {
      ok = false;
      return {};
    }
    std::string s(reinterpret_cast<const char*>(p), q - p);
    p = q + 1;
    return s;
  }
};

int param_count_for_model(int model_id) {
  switch (model_id) {
    case 0: return 3;   // SIMPLE_PINHOLE: f, cx, cy
    case 1: return 4;   // PINHOLE: fx, fy, cx, cy
    case 2: return 4;   // SIMPLE_RADIAL: f, cx, cy, k
    case 3: return 5;   // RADIAL
    case 4: return 8;   // OPENCV
    case 5: return 8;   // OPENCV_FISHEYE
    default: return -1;
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// points3D.bin: returns the point count, fills xyz [n*3] f32 and rgb [n*3]
// f32 if non-null.  Call once with null outputs to size, then again to fill.
// Layout per point: u64 id, 3x f64 xyz, 3x u8 rgb, f64 error, u64 track_len,
// track_len * (i32, i32).
// ---------------------------------------------------------------------------
int64_t gsplat_parse_points3d(const uint8_t* data, int64_t size, float* xyz,
                              float* rgb) {
  Cursor c{data, data + size};
  const uint64_t n = c.read<uint64_t>();
  for (uint64_t i = 0; i < n; i++) {
    c.skip(8);  // point id
    double x = c.read<double>(), y = c.read<double>(), z = c.read<double>();
    uint8_t r = c.read<uint8_t>(), g = c.read<uint8_t>(), b = c.read<uint8_t>();
    c.skip(8);  // reprojection error
    const uint64_t track = c.read<uint64_t>();
    c.skip(track * 8);
    if (!c.ok) return -1;
    if (xyz) {
      xyz[i * 3 + 0] = static_cast<float>(x);
      xyz[i * 3 + 1] = static_cast<float>(y);
      xyz[i * 3 + 2] = static_cast<float>(z);
    }
    if (rgb) {
      rgb[i * 3 + 0] = static_cast<float>(r);
      rgb[i * 3 + 1] = static_cast<float>(g);
      rgb[i * 3 + 2] = static_cast<float>(b);
    }
  }
  return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// images.bin: fills per-image qvec (w,x,y,z) [n*4] f64, tvec [n*3] f64,
// camera_id [n] i32, and a flat NUL-separated name buffer (names_cap bytes).
// Returns image count, or -1 on parse error / -2 if names don't fit.
// ---------------------------------------------------------------------------
int64_t gsplat_parse_images(const uint8_t* data, int64_t size, double* qvec,
                            double* tvec, int32_t* camera_id, char* names,
                            int64_t names_cap) {
  Cursor c{data, data + size};
  const uint64_t n = c.read<uint64_t>();
  int64_t name_pos = 0;
  for (uint64_t i = 0; i < n; i++) {
    c.skip(4);  // image id
    double q[4], t[3];
    for (double& v : q) v = c.read<double>();
    for (double& v : t) v = c.read<double>();
    int32_t cam = c.read<int32_t>();
    std::string name = c.read_string();
    const uint64_t npts = c.read<uint64_t>();
    c.skip(npts * (8 + 8 + 8));  // (x f64, y f64, point3D_id i64)
    if (!c.ok) return -1;
    if (qvec) std::memcpy(qvec + i * 4, q, sizeof(q));
    if (tvec) std::memcpy(tvec + i * 3, t, sizeof(t));
    if (camera_id) camera_id[i] = cam;
    if (names) {
      if (name_pos + static_cast<int64_t>(name.size()) + 1 > names_cap)
        return -2;
      std::memcpy(names + name_pos, name.c_str(), name.size() + 1);
    }
    name_pos += static_cast<int64_t>(name.size()) + 1;
  }
  return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// cameras.bin: fills camera_id [n] i32, model_id [n] i32, width/height [n]
// i64, params [n*8] f64 (zero-padded).  Returns camera count or -1.
// ---------------------------------------------------------------------------
int64_t gsplat_parse_cameras(const uint8_t* data, int64_t size,
                             int32_t* camera_id, int32_t* model_id,
                             int64_t* width, int64_t* height, double* params) {
  Cursor c{data, data + size};
  const uint64_t n = c.read<uint64_t>();
  for (uint64_t i = 0; i < n; i++) {
    int32_t cid = c.read<int32_t>();
    int32_t mid = c.read<int32_t>();
    uint64_t w = c.read<uint64_t>();
    uint64_t h = c.read<uint64_t>();
    int np = param_count_for_model(mid);
    if (np < 0 || !c.ok) return -1;
    double ps[8] = {0};
    for (int k = 0; k < np; k++) ps[k] = c.read<double>();
    if (!c.ok) return -1;
    if (camera_id) camera_id[i] = cid;
    if (model_id) model_id[i] = mid;
    if (width) width[i] = static_cast<int64_t>(w);
    if (height) height[i] = static_cast<int64_t>(h);
    if (params) std::memcpy(params + i * 8, ps, sizeof(ps));
  }
  return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// Gaussian PLY body codec: interleave / deinterleave the per-vertex float
// record [x y z | dc0..2 | rest (m*3) | opacity | scale0..2 | rot0..3].
// The Python side handles the ASCII header.  n = vertices, m = rest coeffs.
// ---------------------------------------------------------------------------
void gsplat_ply_pack(int64_t n, int64_t m, const float* xyz, const float* dc,
                     const float* rest, const float* opacity,
                     const float* scales, const float* rot, float* out) {
  const int64_t stride = 3 + 3 + m * 3 + 1 + 3 + 4;
  for (int64_t i = 0; i < n; i++) {
    float* row = out + i * stride;
    std::memcpy(row, xyz + i * 3, 3 * sizeof(float));
    std::memcpy(row + 3, dc + i * 3, 3 * sizeof(float));
    std::memcpy(row + 6, rest + i * m * 3, m * 3 * sizeof(float));
    row[6 + m * 3] = opacity[i];
    std::memcpy(row + 7 + m * 3, scales + i * 3, 3 * sizeof(float));
    std::memcpy(row + 10 + m * 3, rot + i * 4, 4 * sizeof(float));
  }
}

void gsplat_ply_unpack(int64_t n, int64_t m, const float* in, float* xyz,
                       float* dc, float* rest, float* opacity, float* scales,
                       float* rot) {
  const int64_t stride = 3 + 3 + m * 3 + 1 + 3 + 4;
  for (int64_t i = 0; i < n; i++) {
    const float* row = in + i * stride;
    std::memcpy(xyz + i * 3, row, 3 * sizeof(float));
    std::memcpy(dc + i * 3, row + 3, 3 * sizeof(float));
    std::memcpy(rest + i * m * 3, row + 6, m * 3 * sizeof(float));
    opacity[i] = row[6 + m * 3];
    std::memcpy(scales + i * 3, row + 7 + m * 3, 3 * sizeof(float));
    std::memcpy(rot + i * 4, row + 10 + m * 3, 4 * sizeof(float));
  }
}

}  // extern "C"
