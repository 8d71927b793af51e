// The renderer's primitive pass for Hopper (sm_90a): every env's camera
// frame, from a pixel's ray to its packed colour, depth and segmentation,
// in one launch.
//
// Replaces no TPU kernel: the JAX package's render/raster.py is jnp that XLA
// fuses. In eager PyTorch the same frame (render/raster.py's camera_rays,
// _primitive_block and packing, the plain version this kernel is held to)
// is ~1,400 launches, each writing a (rays, shapes[, 3]) float32 tensor to
// device memory for the next to read back, and every ray pays the sphere,
// box and capsule tests of every shape before one is selected by kind.
//
// Math, per pixel, as the plain version writes it (float32; IEEE division
// and sqrtf; built with -fmad=false so that no multiply and add are fused,
// every sum of a dot product taken left to right):
//   the ray: u = col + 0.5 - W/2, v = row + 0.5 - H/2, the camera-frame
//     direction (1, -u/f, -v/f) divided by its norm, turned by the camera's
//     quaternion (f, the focal length in pixels, is computed by the caller);
//   each shape in order, in its own frame (the camera origin and the ray's
//     direction turned by the inverse of its quaternion), the test of its
//     kind alone: a sphere's, a box's slabs (box and mesh rows), a capsule's
//     cylinder and both end spheres; another kind never hits. The nearest
//     hit wins, the first shape on a tie (t.min's first index);
//   the ground plane (n, d) where |n| > 0.5; the shape wins where nearer;
//   shading once, of the winner: the normal in the shape's frame (the point
//     itself for a sphere, the point less its clamped axis point for a
//     capsule, the dominant face's for a box, argmax's first index), turned
//     to the world and normalized; albedo x (ambient + light x Lambert); the
//     ground 0.55 with its own normal; the sky where nothing is hit;
//   packing: RGBA8 by truncation of clamp(rgb, 0, 1) x 255, alpha 255; the
//     negative view depth t (d . forward) where a hit is nearer than the
//     far plane, else -inf; the shape's segmentation id, else 0.
// The one place where PyTorch fuses is its cross product: torch.linalg.cross's
// CUDA kernel forms a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1)), and so does cross()
// below. Quaternion turns follow math/quat.py: t = 2 (q x v), then
// (v +- w t) + q x t.
//
// What bounds it on this card. At the Ant camera cell's shape (4,096 envs of
// 64 x 48 pixels, 1 sphere and 12 capsules and the ground) a frame is 12.85
// GFLOP of f32 and writes 151 MB (portbench/harness/render_bound.py): 0.19 ms
// at 67 TFLOP/s against 0.05 ms at 3.35 TB/s, so operations bound it. That
// bound counts a fused multiply-add as two operations; with -fmad=false and
// IEEE square roots and divisions (several instructions each) this kernel
// issues more than one instruction an operation, so arithmetic alone keeps
// it under ~50% of the bound. Its design keeps every intermediate in
// registers: a thread a pixel, a block kThreads consecutive pixels of one
// env, the env's shapes staged in shared memory kTile rows at a time with
// what of each test does not depend on the ray (the camera in the shape's
// frame, a sphere's |o|^2 - r^2, a capsule's cylinder and end-sphere terms,
// a box's slab offsets) computed once a block. Every thread of a block tests
// the same shape at once, so the branch on its kind never diverges. Each
// pixel writes 12 bytes: its RGBA8 as one 32-bit store, its depth and its id.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;  // pixels a block
constexpr int kTile = 64;      // shape rows staged in shared memory at a time
constexpr int kSphere = 0, kBox = 1, kCapsule = 2, kMesh = 3;  // core/scene.py SHAPE_*
constexpr float kBig = 1e30f;  // render/raster.py BIG: no hit
constexpr float kEps = 1e-4f;  // the nearest distance a hit counts from

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ float4 load4(const float* p) { return {p[0], p[1], p[2], p[3]}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// torch.linalg.cross's rounding on the card: the first product fused
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z),
          cross_term(a.x, b.y, a.y, b.x)};
}

// math/quat.py quat_rotate (sign 1) and quat_rotate_inverse (sign -1)
template <int kSign>
__device__ __forceinline__ V3 turn(float4 q, V3 v) {
  const V3 u = {q.x, q.y, q.z};
  const V3 c = cross(u, v);
  const V3 t = {2.0f * c.x, 2.0f * c.y, 2.0f * c.z};
  const V3 e = cross(u, t);
  if (kSign > 0) return {(v.x + q.w * t.x) + e.x, (v.y + q.w * t.y) + e.y, (v.z + q.w * t.z) + e.z};
  return {(v.x - q.w * t.x) + e.x, (v.y - q.w * t.y) + e.y, (v.z - q.w * t.z) + e.z};
}

__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// _ray_sphere's distance from b = oc . d and q = |oc|^2 - r^2
__device__ __forceinline__ float sphere_t(float b, float q) {
  const float disc = b * b - q;
  const float t = -b - sqrtf(clamp0(disc));
  return (disc >= 0.0f && t > kEps) ? t : kBig;
}

// _signed_eps(x, 1e-9)
__device__ __forceinline__ float signed_eps(float x) {
  return fabsf(x) < 1e-9f ? (x >= 0.0f ? 1e-9f : -1e-9f) : x;
}

// A staged shape: its world quaternion; the camera origin in its frame and
// its kind; six ray-independent terms of its kind's test (a sphere: q;
// a capsule: the cylinder's c, hl, and each end sphere's oc_z and q; a box:
// the slab offsets -half - o and half - o).
struct Row {
  float4 quat, origin, a, b;
};

__device__ __forceinline__ Row stage(V3 o, const float* pos, const float* quat,
                                     const float* size, int kind) {
  Row r;
  r.quat = load4(quat);
  const float4 q = r.quat;
  const V3 ol = turn<-1>(q, {o.x - pos[0], o.y - pos[1], o.z - pos[2]});
  r.origin = {ol.x, ol.y, ol.z, __int_as_float(kind)};
  r.a = r.b = {0.0f, 0.0f, 0.0f, 0.0f};
  const float rad = size[0], rr = rad * rad;
  if (kind == kSphere) {
    r.a.x = dot(ol, ol) - rr;
  } else if (kind == kCapsule) {
    const float hl = size[1], xy = ol.x * ol.x + ol.y * ol.y;
    const float zt = ol.z - hl, zb = ol.z + hl;  // o - (0, 0, hl), o - (0, 0, -hl)
    r.a = {xy - rr, hl, zt, (xy + zt * zt) - rr};
    r.b = {zb, (xy + zb * zb) - rr, 0.0f, 0.0f};
  } else if (kind == kBox || kind == kMesh) {
    r.a = {-size[0] - ol.x, -size[1] - ol.y, -size[2] - ol.z, size[0] - ol.x};
    r.b = {size[1] - ol.y, size[2] - ol.z, 0.0f, 0.0f};
  }
  return r;
}

// The distance along d (world) of the staged shape's nearest hit, or kBig.
__device__ __forceinline__ float hit_t(const Row& r, V3 d) {
  const int kind = __float_as_int(r.origin.w);
  const V3 o = {r.origin.x, r.origin.y, r.origin.z};
  const V3 dl = turn<-1>(r.quat, d);
  if (kind == kSphere) return sphere_t(dot(o, dl), r.a.x);
  if (kind == kCapsule) {
    const float a = dl.x * dl.x + dl.y * dl.y;
    const float b = o.x * dl.x + o.y * dl.y;
    const float disc = b * b - a * r.a.x;
    const float root = sqrtf(clamp0(disc));
    const float t = (-b - root) / (a < 1e-12f ? 1e-12f : a);
    const float z = o.z + t * dl.z;
    const float t_cyl =
        (disc >= 0.0f && t > kEps && fabsf(z) <= r.a.y && a >= 1e-12f) ? t : kBig;
    const float t_top = sphere_t(b + r.a.z * dl.z, r.a.w);
    const float t_bot = sphere_t(b + r.b.x * dl.z, r.b.y);
    return fminf(t_cyl, fminf(t_top, t_bot));
  }
  if (kind == kBox || kind == kMesh) {
    const float ix = 1.0f / signed_eps(dl.x), iy = 1.0f / signed_eps(dl.y),
                iz = 1.0f / signed_eps(dl.z);
    const float x0 = r.a.x * ix, x1 = r.a.w * ix;
    const float y0 = r.a.y * iy, y1 = r.b.x * iy;
    const float z0 = r.a.z * iz, z1 = r.b.y * iz;
    const float tmin = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
    const float tmax = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
    const bool hit = tmax >= fmaxf(tmin, kEps) && tmax > 0.0f;
    return hit ? (tmin > kEps ? tmin : tmax) : kBig;
  }
  return kBig;
}

// The world normal of a hit at p (world) on shape row `s` of an env: in the
// shape's frame, then turned and normalized.
__device__ __forceinline__ V3 shape_normal(V3 p, const float* pos, const float* quat,
                                          const float* size, int kind) {
  const float4 q = load4(quat);
  const V3 pl = turn<-1>(q, {p.x - pos[0], p.y - pos[1], p.z - pos[2]});
  V3 nl;
  if (kind == kSphere) {
    nl = pl;
  } else if (kind == kCapsule) {
    const float zc = fminf(fmaxf(pl.z, -size[1]), size[1]);
    nl = {pl.x - 0.0f, pl.y - 0.0f, pl.z - zc};
  } else {  // the dominant face, argmax's first index
    const float rx = fabsf(pl.x) / fmaxf(size[0], 1e-6f);
    const float ry = fabsf(pl.y) / fmaxf(size[1], 1e-6f);
    const float rz = fabsf(pl.z) / fmaxf(size[2], 1e-6f);
    int ax = 0;
    float m = rx;
    if (ry > m) ax = 1, m = ry;
    if (rz > m) ax = 2;
    const float c = ax == 0 ? pl.x : (ax == 1 ? pl.y : pl.z);
    const float sgn = c > 0.0f ? 1.0f : (c < 0.0f ? -1.0f : 0.0f);
    nl = {(ax == 0 ? 1.0f : 0.0f) * sgn, (ax == 1 ? 1.0f : 0.0f) * sgn,
          (ax == 2 ? 1.0f : 0.0f) * sgn};
  }
  return turn<1>(q, nl);
}

__device__ __forceinline__ V3 unit(V3 n) {
  const float len = fmaxf(sqrtf(dot(n, n)), 1e-9f);
  return {n.x / len, n.y / len, n.z / len};
}

__device__ __forceinline__ unsigned int to_u8(float c) {
  return (unsigned int)(int)(fminf(fmaxf(c, 0.0f), 1.0f) * 255.0f);
}

struct Scene {
  const float* ground;  // (4,) normal, distance; zeros when absent
  const float* light_dir;
  const float* light_color;
  const float* ambient;
  const float* sky;
};

__global__ void __launch_bounds__(kThreads) raycast(
    const float* __restrict__ cam_pos, const float* __restrict__ cam_quat,
    const float* __restrict__ focal, const float* __restrict__ forward,
    const float* __restrict__ shape_pos, const float* __restrict__ shape_quat,
    const float* __restrict__ shape_size, const int* __restrict__ kind,
    const float* __restrict__ color, const int* __restrict__ seg, Scene scene, float far,
    int S, int W, int H, uchar4* __restrict__ rgba, float* __restrict__ depth,
    int* __restrict__ seg_img) {
  __shared__ Row rows[kTile];
  const int P = W * H, chunks = (P + kThreads - 1) / kThreads;
  const int env = blockIdx.x / chunks;
  const int pix = (blockIdx.x % chunks) * kThreads + threadIdx.x;
  const bool live = pix < P;
  const long long shape0 = (long long)env * S;

  const V3 o = load3(cam_pos + 3LL * env);
  // the pixel's ray: camera_rays
  const float f = focal[env];
  const float u = ((float)(pix % W) + 0.5f) - 0.5f * (float)W;
  const float v = ((float)(pix / W) + 0.5f) - 0.5f * (float)H;
  const float y = -u / f, z = -v / f;
  const float len = sqrtf((1.0f + y * y) + z * z);
  const V3 d = turn<1>(load4(cam_quat + 4LL * env), {1.0f / len, y / len, z / len});

  float best_t = INFINITY;
  int best = -1;
  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int count = S - s0 < kTile ? S - s0 : kTile;
    __syncthreads();  // the last tile's rows are read
    if (threadIdx.x < count) {
      const long long s = shape0 + s0 + threadIdx.x;
      rows[threadIdx.x] = stage(o, shape_pos + 3 * s, shape_quat + 4 * s, shape_size + 3 * s,
                                kind[s]);
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < count; ++k) {
        const float t = hit_t(rows[k], d);
        // t.min(-1): the first least, a NaN before any number
        if (best < 0 || t < best_t || (isnan(t) && !isnan(best_t))) best_t = t, best = s0 + k;
      }
    }
  }
  if (!live) return;

  // the ground plane
  const float4 g = load4(scene.ground);
  const V3 gn = {g.x, g.y, g.z};
  const float denom = dot(d, gn);
  float t_gnd = (g.w - dot(o, gn)) / (fabsf(denom) < 1e-9f ? 1e-9f : denom);
  t_gnd = (sqrtf(dot(gn, gn)) > 0.5f && t_gnd > kEps) ? t_gnd : kBig;
  const bool hit_shape = best_t < fminf(t_gnd, kBig * 0.5f);
  const bool hit_gnd = !hit_shape && t_gnd < kBig * 0.5f;
  const float t = hit_shape ? best_t : t_gnd;

  // shading, of the winner
  const long long out = (long long)env * P + pix;
  float r = scene.sky[0], gc = scene.sky[1], b = scene.sky[2];
  if (hit_shape || hit_gnd) {
    V3 n = gn, albedo = {0.55f, 0.55f, 0.55f};
    if (hit_shape) {
      const long long s = shape0 + best;
      n = shape_normal({o.x + t * d.x, o.y + t * d.y, o.z + t * d.z}, shape_pos + 3 * s,
                       shape_quat + 4 * s, shape_size + 3 * s, kind[s]);
      albedo = load3(color + 3 * s);
    }
    n = unit(n);
    const float lambert = fminf(fmaxf(-dot(n, load3(scene.light_dir)), 0.0f), 1.0f);
    const V3 lc = load3(scene.light_color), amb = load3(scene.ambient);
    r = albedo.x * (amb.x + lc.x * lambert);
    gc = albedo.y * (amb.y + lc.y * lambert);
    b = albedo.z * (amb.z + lc.z * lambert);
  }
  rgba[out] = make_uchar4(to_u8(r), to_u8(gc), to_u8(b), 255);
  depth[out] = (hit_shape || hit_gnd) && t < far ? -(t * dot(d, load3(forward + 3LL * env)))
                                                 : -INFINITY;
  seg_img[out] = hit_shape ? seg[shape0 + best] : 0;
}

__global__ void cross_rows(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 c = cross(load3(a + 3 * i), load3(b + 3 * i));
  out[3 * i] = c.x, out[3 * i + 1] = c.y, out[3 * i + 2] = c.z;
}

}  // namespace

// Launches one frame of N envs' cameras on `stream`. cam_pos (N, 3),
// cam_quat (N, 4), focal (N,), forward (N, 3); shape_pos (N, S, 3), shape_quat
// (N, S, 4), shape_size (N, S, 3), kind (N, S) int32, color (N, S, 3), seg (N,
// S) int32; ground (4,), light_dir, light_color, ambient, sky (3,) each;
// every array contiguous on the current device. Writes rgba (N, H, W, 4)
// uint8, depth (N, H, W) float32 and seg_img (N, H, W) int32. Returns
// cudaGetLastError() after the launch: 0 if it was accepted.
extern "C" int raycast_forward(
    const float* cam_pos, const float* cam_quat, const float* focal, const float* forward,
    const float* shape_pos, const float* shape_quat, const float* shape_size, const int* kind,
    const float* color, const int* seg, const float* ground, const float* light_dir,
    const float* light_color, const float* ambient, const float* sky, float far, int N, int S,
    int W, int H, unsigned char* rgba, float* depth, int* seg_img, void* stream) {
  if (N <= 0 || S < 0 || W <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long chunks = ((long long)W * H + kThreads - 1) / kThreads;
  if ((long long)W * H > 0x7fffffffLL || chunks * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  raycast<<<(unsigned)(chunks * N), kThreads, 0, (cudaStream_t)stream>>>(
      cam_pos, cam_quat, focal, forward, shape_pos, shape_quat, shape_size, kind, color, seg,
      Scene{ground, light_dir, light_color, ambient, sky}, far, S, W, H,
      reinterpret_cast<uchar4*>(rgba), depth, seg_img);
  return (int)cudaGetLastError();
}

// out (n, 3) = the kernel's cross product of a (n, 3) and b (n, 3): for the
// test that holds it to torch.linalg.cross on the card.
extern "C" int raycast_cross(const float* a, const float* b, float* out, long long n,
                             void* stream) {
  if (n <= 0 || (n + 255) / 256 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cross_rows<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(a, b, out, n);
  return (int)cudaGetLastError();
}
