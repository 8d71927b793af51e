// One XPBD soft-body substep for Hopper (sm_90a): the prediction, every
// Jacobi iteration, the ground friction and the damping of every env in one
// launch.
//
// Replaces no TPU kernel: the JAX package's physics/soft.py::SoftStepper.substep
// is a Python loop of jnp ops that XLA fuses. In eager PyTorch the same loop
// (physics/soft.py::SoftStepper._substep_torch, the plain version this kernel
// is held to) is ~90 launches an iteration, 80 iterations a substep, and the
// memory traffic of its (N, T, 4, 3) temporaries takes ~1.35 ms of device
// time an iteration for an env whose whole state is a few KB.
//
// Math, per env, as the plain version writes it (float32, IEEE division and
// sqrtf; built with -fmad=false so no multiply and add are fused, and every
// sum is taken left to right):
//   prediction  v = vel + h g,  p = pos + h v;
//   per iteration, both constraints of each tet from the same positions:
//     F^T = Dm^-T Ds^T (rows x_{j+1} - x_0);
//     deviatoric C_D = |F|_F (clamped at 1e-12 before the root), gradient
//       rows Dm^-1 (F^T / C_D), corner 0's minus the sum of the others';
//     hydrostatic C_H = det F - gamma, cof(F)^T rows cross(F^T_{i+1}, F^T_{i+2}),
//       det F = F^T_0 . cof^T_0, gradient rows Dm^-1 cof^T;
//     each dlam = -(C + alpha lam) / max(sum_c w_c |g_c|^2 + alpha, 1e-9) x
//       the tet's relaxed Jacobi scale; lam += dlam;
//     each corner's correction (w_c g_c) dlam;
//   then each vertex adds its corrections (the deviatoric ones by corner then
//   tet, then the hydrostatic ones in the same order), leaves the ground
//   plane grown by the margin, and leaves each collider in collider order
//   (sphere, box with argmax's first-wins tie rule, capsule, convex hull by
//   its first maximal plane);
//   after the iterations, Coulomb-style ground friction once, v = (p - pos) / h
//   and the damping of the vertex's instance, clamped to [0, 1].
//
// What bounds it on this card. At the soft cell's widths (195 vertices, 570
// tets, 1 box, 80 iterations, 1,024 envs) a substep's work is ~52 GFLOP of
// f32 (portbench/harness/xpbd_bound.py: 0.26 ms at the 67 TFLOP/s peak),
// while its bytes are ~2 MB: operations bound it. Its design keeps every
// per-iteration quantity on chip: one block an env, its positions, both
// multipliers, the compliances and every corner's correction in shared
// memory for all the iterations (4 (3V + 29T + 10M) bytes: 68,500 for the
// icosphere, three blocks an SM), the mesh's constants read through L1 from
// one table every env shares. Each iteration is a tet phase (a thread two
// tets) and a vertex phase (a thread a vertex, taken in descending valence
// so a warp's sums are of like length), with a barrier after each: there is
// no atomic, so a substep is bitwise repeatable, whatever the block's size.
// At the soft cell's widths a block is 288 threads, 61 registers each: 2.37
// ms a substep on an H100, against 2.79 ms with 192 threads (three tets a
// thread), 2.87 with 512 (one; two blocks an SM) and 3.21 with 160 (four).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kTetsPerThread = 2;
constexpr int kSphere = 0, kBox = 1, kCapsule = 2, kHull = 3;  // core/scene.py SHAPE_*
constexpr int kPoseFloats = 10;  // a collider's position 3, rotation 4, size 3

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }

// torch.linalg.cross
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// math/quat.py::quat_mul: a * b
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
          a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z};
}

// math/quat.py::quat_rotate (sign 1) and quat_rotate_inverse (sign -1):
// v +- w t + qv x t, t = 2 (qv x v)
__device__ __forceinline__ V3 rotate(Q4 q, V3 v, float sign) {
  const V3 qv{q.x, q.y, q.z};
  const V3 t = scale(cross(qv, v), 2.0f);
  const V3 wt = scale(t, q.w);
  const V3 vw = sign > 0.f ? add(v, wt) : sub(v, wt);
  return add(vw, cross(qv, t));
}

// torch.clamp's order of tests, so a NaN passes through as it does there
__device__ __forceinline__ float at_least(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float at_most(float x, float hi) { return x > hi ? hi : x; }

struct Mesh {                // one table every env reads
  const int4* tets;          // (T) corner vertices
  const float* inv_dm;       // (T, 9) Dm^-1, row-major
  const float4* w4;          // (T) corner inverse masses
  const float* jac;          // (T) relaxed Jacobi scale
  const int* inc_start;      // (V + 1) offsets into inc_slot
  const int* inc_slot;       // (4T) k * 3T + t of each (tet t, corner k) at a vertex, by (k, t)
  const int* vert_order;     // (V) the vertices by descending valence
  const int* vert_inst;      // (V) the instance of the vertex's tets, -1 for none
  const int* col;            // (M, 3) body slot, shape slot, kind
  const float4* col_quat;    // (M) the shape's rotation in its body
  const float4* planes;      // (M, F, 2) a hull's planes: (n, d), (margin |n|, |n|^2 clipped, 0, 0)
  int V, T, M, F;
};

struct Env {                 // each env's inputs and outputs
  const float* pos;          // (N, V, 3)
  const float* vel;          // (N, V, 3)
  const float* alpha_d;      // (N, T) compliances over h^2
  const float* alpha_h;      // (N, T)
  const float* gamma;        // (N, T) hydrostatic rest offset
  const float* damping;      // (N, I) per instance
  const float* body_pos;     // (N, B, 3)
  const float* body_quat;    // (N, B, 4)
  const float* shape_pos;    // (N, S, 3)
  const float* shape_size;   // (N, S, 3)
  const float* gravity;      // (3)
  float* pos_out;            // (N, V, 3)
  float* vel_out;            // (N, V, 3)
  int I, B, S;
};

struct Scalars {
  float h, inv_h, nx, ny, nz, plane_d, margin, friction;
  int has_ground, iters;
};

// One constraint's relaxed dlam from its value C, its compliance alpha, its
// accumulated lam and its four corners' gradients g (rows).
__device__ __forceinline__ float delta(const V3 g[4], float4 w, float C, float alpha, float lam,
                                       float jac) {
  const float wsum = dot(g[0], g[0]) * w.x + dot(g[1], g[1]) * w.y + dot(g[2], g[2]) * w.z +
                     dot(g[3], g[3]) * w.w;
  const float dl = -(C + alpha * lam) / at_least(wsum + alpha, 1e-9f);
  return dl * jac;
}

// Rows Dm^-1 r of the 3 x 3 rows r, then corner 0's row minus their sum.
__device__ __forceinline__ void corners(const float a[9], const V3 r[3], V3 g[4]) {
  for (int i = 0; i < 3; ++i)
    g[i + 1] = add(add(scale(r[0], a[3 * i]), scale(r[1], a[3 * i + 1])), scale(r[2], a[3 * i + 2]));
  const V3 s = add(add(g[1], g[2]), g[3]);
  g[0] = {-s.x, -s.y, -s.z};
}

// corr (2, 4, 3, T): constraint, corner, axis, tet
__device__ __forceinline__ void store_corrections(float* corr, int T, int t, const V3 g[4],
                                                  float4 w, float dl) {
  const float wc[4] = {w.x, w.y, w.z, w.w};
  for (int k = 0; k < 4; ++k) {
    const V3 c = scale(scale(g[k], wc[k]), dl);
    corr[(3 * k) * T + t] = c.x;
    corr[(3 * k + 1) * T + t] = c.y;
    corr[(3 * k + 2) * T + t] = c.z;
  }
}

__device__ __forceinline__ void tet_phase(const Mesh& m, int t, const float* px, const float* py,
                                          const float* pz, float* lam_d, float* lam_h,
                                          const float* a_d, const float* a_h, const float* gam,
                                          float* corr) {
  const int T = m.T;
  const int4 q = __ldg(m.tets + t);
  const int ci[4] = {q.x, q.y, q.z, q.w};
  V3 x[4];
  for (int k = 0; k < 4; ++k) x[k] = {px[ci[k]], py[ci[k]], pz[ci[k]]};
  const V3 d[3] = {sub(x[1], x[0]), sub(x[2], x[0]), sub(x[3], x[0])};
  float a[9];
  for (int i = 0; i < 9; ++i) a[i] = __ldg(m.inv_dm + 9 * t + i);
  const float4 w = __ldg(m.w4 + t);
  const float jac = __ldg(m.jac + t);
  // F^T = Dm^-T Ds^T: row i is sum_j Dm^-1[j][i] d_j
  V3 ft[3];
  for (int i = 0; i < 3; ++i)
    ft[i] = add(add(scale(d[0], a[i]), scale(d[1], a[3 + i])), scale(d[2], a[6 + i]));

  // deviatoric
  const float ss = ((((((((ft[0].x * ft[0].x + ft[0].y * ft[0].y) + ft[0].z * ft[0].z) +
                         ft[1].x * ft[1].x) + ft[1].y * ft[1].y) + ft[1].z * ft[1].z) +
                      ft[2].x * ft[2].x) + ft[2].y * ft[2].y) + ft[2].z * ft[2].z);
  const float fn = sqrtf(at_least(ss, 1e-12f));
  const V3 u[3] = {{ft[0].x / fn, ft[0].y / fn, ft[0].z / fn},
                   {ft[1].x / fn, ft[1].y / fn, ft[1].z / fn},
                   {ft[2].x / fn, ft[2].y / fn, ft[2].z / fn}};
  V3 g[4];
  corners(a, u, g);
  const float dl = delta(g, w, fn, a_d[t], lam_d[t], jac);
  lam_d[t] = lam_d[t] + dl;
  store_corrections(corr, T, t, g, w, dl);

  // hydrostatic
  const V3 cof[3] = {cross(ft[1], ft[2]), cross(ft[2], ft[0]), cross(ft[0], ft[1])};
  const float det = dot(ft[0], cof[0]);
  corners(a, cof, g);
  const float dlh = delta(g, w, det - gam[t], a_h[t], lam_h[t], jac);
  lam_h[t] = lam_h[t] + dlh;
  store_corrections(corr + 12 * T, T, t, g, w, dlh);
}

// p moved out of collider c (its pose and size in `pose`)
__device__ __forceinline__ V3 collide(const Mesh& m, int c, const float* pose, float margin, V3 p) {
  const V3 cp{pose[0], pose[1], pose[2]};
  const Q4 cq{pose[3], pose[4], pose[5], pose[6]};
  const V3 csz{pose[7], pose[8], pose[9]};
  const int kind = __ldg(m.col + 3 * c + 2);
  if (kind == kSphere) {
    const V3 rel = sub(p, cp);
    const float r = csz.x + margin;
    const float d = at_least(norm(rel), 1e-9f);
    if (!(d < r)) return p;
    const V3 dir{rel.x / d, rel.y / d, rel.z / d};
    return add(cp, scale(dir, r));
  }
  const V3 rel = rotate(cq, sub(p, cp), -1.f);
  V3 fixed;
  if (kind == kCapsule) {  // a segment along local z
    const float r = csz.x + margin, hl = csz.y;
    const float zc = fminf(fmaxf(rel.z, -hl), hl);
    const V3 off{rel.x, rel.y, rel.z - zc};
    const float d = at_least(norm(off), 1e-9f);
    if (!(d < r)) return p;
    const V3 dir{off.x / d, off.y / d, off.z / d};
    fixed = {dir.x * r, dir.y * r, zc + dir.z * r};
  } else if (kind == kHull) {  // out through the first maximal plane
    const float4* pl = m.planes + 2 * (long long)c * m.F;
    float dmax = 0.f;
    float4 hit = make_float4(0.f, 0.f, 0.f, 0.f), hit2 = hit;
    for (int f = 0; f < m.F; ++f) {
      const float4 nd = __ldg(pl + 2 * f), mn = __ldg(pl + 2 * f + 1);
      const float dd = (rel.x * nd.x + rel.y * nd.y + rel.z * nd.z) + nd.w - mn.x;
      if (f == 0 || dd > dmax) {
        dmax = dd;
        hit = nd;
        hit2 = mn;
      }
    }
    if (!(dmax < 0.f)) return p;
    const float s = dmax / hit2.y;
    fixed = {rel.x - s * hit.x, rel.y - s * hit.y, rel.z - s * hit.z};
  } else {  // box: onto the face of the largest |rel| - half, the first of a tie
    const V3 half{csz.x + margin, csz.y + margin, csz.z + margin};
    const float qx = fabsf(rel.x) - half.x, qy = fabsf(rel.y) - half.y, qz = fabsf(rel.z) - half.z;
    if (!(qx < 0.f && qy < 0.f && qz < 0.f)) return p;
    int ax = 0;
    float qm = qx;
    if (qy > qm) {
      ax = 1;
      qm = qy;
    }
    if (qz > qm) ax = 2;
    fixed = rel;
    const float r = ax == 0 ? rel.x : (ax == 1 ? rel.y : rel.z);
    const float sg = r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f);
    if (ax == 0) fixed.x = sg * half.x;
    else if (ax == 1) fixed.y = sg * half.y;
    else fixed.z = sg * half.z;
  }
  return add(cp, rotate(cq, fixed, 1.f));
}

__global__ void __launch_bounds__(kMaxThreads) xpbd_substep(Mesh m, Env e, Scalars s) {
  extern __shared__ float sm[];
  const int V = m.V, T = m.T, M = m.M;
  float* px = sm;
  float* py = px + V;
  float* pz = py + V;
  float* lam_d = pz + V;
  float* lam_h = lam_d + T;
  float* a_d = lam_h + T;
  float* a_h = a_d + T;
  float* gam = a_h + T;
  float* corr = gam + T;       // (2, 4, 3, T)
  float* pose = corr + 24 * T;  // (M, kPoseFloats)
  const int n = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long nv = (long long)n * V, ntt = (long long)n * T;
  const V3 pn{s.nx, s.ny, s.nz};

  // the prediction
  const V3 g{__ldg(e.gravity), __ldg(e.gravity + 1), __ldg(e.gravity + 2)};
  const V3 hg = scale(g, s.h);
  for (int v = tid; v < V; v += nt) {
    const float* x = e.pos + 3 * (nv + v);
    const float* u = e.vel + 3 * (nv + v);
    const V3 vv = add(V3{__ldg(u), __ldg(u + 1), __ldg(u + 2)}, hg);
    const V3 p = add(V3{__ldg(x), __ldg(x + 1), __ldg(x + 2)}, scale(vv, s.h));
    px[v] = p.x;
    py[v] = p.y;
    pz[v] = p.z;
  }
  for (int t = tid; t < T; t += nt) {
    lam_d[t] = 0.f;
    lam_h[t] = 0.f;
    a_d[t] = __ldg(e.alpha_d + ntt + t);
    a_h[t] = __ldg(e.alpha_h + ntt + t);
    gam[t] = __ldg(e.gamma + ntt + t);
  }
  // the colliders' poses: body pose composed with the shape's
  for (int c = tid; c < M; c += nt) {
    const int b = __ldg(m.col + 3 * c), sh = __ldg(m.col + 3 * c + 1);
    const float* bp = e.body_pos + 3 * ((long long)n * e.B + b);
    const float* bq = e.body_quat + 4 * ((long long)n * e.B + b);
    const float* sp = e.shape_pos + 3 * ((long long)n * e.S + sh);
    const float* sz = e.shape_size + 3 * ((long long)n * e.S + sh);
    const Q4 q{__ldg(bq), __ldg(bq + 1), __ldg(bq + 2), __ldg(bq + 3)};
    const V3 cp = add(V3{__ldg(bp), __ldg(bp + 1), __ldg(bp + 2)},
                      rotate(q, V3{__ldg(sp), __ldg(sp + 1), __ldg(sp + 2)}, 1.f));
    const float4 r = __ldg(m.col_quat + c);
    const Q4 cq = qmul(q, Q4{r.x, r.y, r.z, r.w});
    float* o = pose + kPoseFloats * c;
    o[0] = cp.x; o[1] = cp.y; o[2] = cp.z;
    o[3] = cq.x; o[4] = cq.y; o[5] = cq.z; o[6] = cq.w;
    o[7] = __ldg(sz); o[8] = __ldg(sz + 1); o[9] = __ldg(sz + 2);
  }
  __syncthreads();

  for (int it = 0; it < s.iters; ++it) {
    for (int t = tid; t < T; t += nt) tet_phase(m, t, px, py, pz, lam_d, lam_h, a_d, a_h, gam, corr);
    __syncthreads();
    for (int j = tid; j < V; j += nt) {
      const int v = __ldg(m.vert_order + j);
      const int i0 = __ldg(m.inc_start + v), i1 = __ldg(m.inc_start + v + 1);
      float sx = 0.f, sy = 0.f, sz = 0.f;
      for (int c = 0; c < 2; ++c) {
        const float* cc = corr + 12 * T * c;
        for (int i = i0; i < i1; ++i) {
          const int b = __ldg(m.inc_slot + i);
          sx += cc[b];
          sy += cc[b + T];
          sz += cc[b + 2 * T];
        }
      }
      V3 p{px[v] + sx, py[v] + sy, pz[v] + sz};
      if (s.has_ground) {
        const float d = dot(p, pn) - s.plane_d - s.margin;
        p = sub(p, scale(pn, at_most(d, 0.f)));
      }
      for (int c = 0; c < M; ++c) p = collide(m, c, pose + kPoseFloats * c, s.margin, p);
      px[v] = p.x;
      py[v] = p.y;
      pz[v] = p.z;
    }
    __syncthreads();
  }

  // once a substep: ground friction, the velocity, the damping
  for (int j = tid; j < V; j += nt) {
    const int v = __ldg(m.vert_order + j);
    const float* xp = e.pos + 3 * (nv + v);
    const float* up = e.vel + 3 * (nv + v);
    const V3 x0{__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
    V3 p{px[v], py[v], pz[v]};
    if (s.has_ground) {
      const V3 u0{__ldg(up), __ldg(up + 1), __ldg(up + 2)};
      const float d0 = dot(x0, pn) - s.plane_d - s.margin;
      const float appr = at_least(-(d0 + s.h * dot(u0, pn)), 0.f);
      const V3 mot = sub(p, x0);
      const V3 tan = sub(mot, scale(pn, dot(mot, pn)));
      const float tn = at_least(norm(tan), 1e-9f);
      const float keep = at_most(at_least(1.f - s.friction * appr / tn, 0.f), 1.f);
      if (appr > 0.f) p = sub(p, scale(tan, 1.f - keep));
    }
    const int inst = __ldg(m.vert_inst + v);
    const float dv = at_least(inst >= 0 ? __ldg(e.damping + (long long)n * e.I + inst) : 0.f, 0.f);
    const float keep_v = at_most(at_least(1.f - dv, 0.f), 1.f);
    // (p - pos) / h as PyTorch's CUDA division by a scalar takes it: times 1/h
    const V3 vel = scale(scale(sub(p, x0), s.inv_h), keep_v);
    float* po = e.pos_out + 3 * (nv + v);
    float* vo = e.vel_out + 3 * (nv + v);
    po[0] = p.x; po[1] = p.y; po[2] = p.z;
    vo[0] = vel.x; vo[1] = vel.y; vo[2] = vel.z;
  }
}

}  // namespace

// Shared memory a block takes: positions 3V, lam_D, lam_H, alpha_D, alpha_H,
// gamma 5T, corrections 24T, collider poses 10M floats.
extern "C" long long xpbd_shared_bytes(int V, int T, int M) {
  return 4LL * (3LL * V + 29LL * T + (long long)kPoseFloats * M);
}

// Threads a block: kTetsPerThread tets a thread, whole warps, at most kMaxThreads.
extern "C" int xpbd_threads(int T) {
  const int want = ((T + kTetsPerThread - 1) / kTetsPerThread + 31) / 32 * 32;
  return want < 32 ? 32 : (want > kMaxThreads ? kMaxThreads : want);
}

// Blocks of a mesh of V vertices, T tets and M colliders that one SM holds at
// once on the current device (after the first launch has granted the opt-in
// shared memory), or a negative CUDA error.
extern "C" int xpbd_blocks_per_sm(int V, int T, int M) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, xpbd_substep, xpbd_threads(T), (size_t)xpbd_shared_bytes(V, T, M));
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches one substep of N envs on `stream`. Every array is contiguous, on
// the current device; shapes as in Mesh and Env above. Returns
// cudaGetLastError() after the launch: 0 if it was accepted.
extern "C" int xpbd_launch(
    const int* tets, const float* inv_dm, const float* w4, const float* jac, const int* inc_start,
    const int* inc_slot, const int* vert_order, const int* vert_inst, const int* col,
    const float* col_quat, const float* planes, int V, int T, int M, int F,
    const float* pos, const float* vel, const float* alpha_d, const float* alpha_h,
    const float* gamma, const float* damping, int I, const float* body_pos,
    const float* body_quat, int B, const float* shape_pos, const float* shape_size, int S,
    const float* gravity, float* pos_out, float* vel_out, int N, int iters, int has_ground,
    float h, float nx, float ny, float nz, float plane_d, float margin, float friction,
    void* stream) {
  if (N <= 0 || V <= 0 || T <= 0 || M < 0 || F <= 0 || iters < 0 || I <= 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = xpbd_shared_bytes(V, T, M);
  // the opt-in maximum, looked up and granted once per device
  static int granted[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (granted[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(xpbd_substep, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    // the most shared memory an SM can give: three icosphere blocks need 208.5 KB of it
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(xpbd_substep, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = optin;
  }
  if (smem > granted[dev]) return (int)cudaErrorInvalidValue;
  const Mesh m{reinterpret_cast<const int4*>(tets), inv_dm, reinterpret_cast<const float4*>(w4),
               jac, inc_start, inc_slot, vert_order, vert_inst, col,
               reinterpret_cast<const float4*>(col_quat), reinterpret_cast<const float4*>(planes),
               V, T, M, F};
  const Env e{pos, vel, alpha_d, alpha_h, gamma, damping, body_pos, body_quat, shape_pos,
              shape_size, gravity, pos_out, vel_out, I, B, S};
  const Scalars s{h, 1.f / h, nx, ny, nz, plane_d, margin, friction, has_ground, iters};
  xpbd_substep<<<N, xpbd_threads(T), (size_t)smem, (cudaStream_t)stream>>>(m, e, s);
  return (int)cudaGetLastError();
}
