// Articulated forward kinematics for Hopper (sm_90a): every link of every
// batch element in one launch.
//
// Replaces no TPU kernel: the JAX package's physics/kinematics.py::fk is a
// Python loop over the links that XLA fuses into a few kernels. In eager
// PyTorch the same loop (physics/kinematics.py::_fk_torch, the plain version
// this kernel is held to) is ~100 small batched ops a link, ~1,185 launches a
// call on the 12-link Panda, twice a step on the Franka path, and the host's
// launch overhead is most of that path's step. This kernel does the whole
// call in one launch.
//
// Math, per batch element (the leading axes of the inputs flattened), link by
// link in index order, each link's parent earlier (parent[i] < i): the root
// link copies the root pose and velocity; any other link i puts its joint
// frame on its parent p,
//   jf_pos = pos[p] + rotate(quat[p], jp_pos[i]),  jf_quat = quat[p] * jp_quat[i],
// then, by its joint type,
//   revolute:  post = jf_quat * (axis sin(q/2), cos(q/2)),  a = rotate(jf_quat, axis),
//              quat = post * jc_quat,  pos = jf_pos + rotate(post, jc_pos),
//              w = w[p] + a qd,
//              v = v[p] + w[p] x (jf_pos - pos[p]) + (a qd) x (pos - jf_pos);
//   prismatic: a = rotate(jf_quat, axis),  quat = jf_quat * jc_quat,
//              pos = jf_pos + a q + rotate(jf_quat, jc_pos),
//              w = w[p],  v = v[p] + w[p] x (pos - pos[p]) + a qd;
//   fixed:     quat = jf_quat * jc_quat,  pos = jf_pos + rotate(jf_quat, jc_pos),
//              w = w[p],  v = v[p] + w[p] x (pos - pos[p]).
// Quaternions are xyzw; every product, rotation and cross product is written
// out in the plain version's order of operations, in float32, with sinf and
// cosf.
//
// What bounds it on this card. At the Franka path's shape (4,096 envs, 12
// links, 9 dofs) a call reads 31 floats and writes 12 x 13 floats an env:
// 4,096 x 187 x 4 B = 3.06 MB, ~0.9 us at 3.35 TB/s; its ~2,000 flops an env
// are nothing beside that. Its design target is launch latency: one launch,
// no shared memory, no synchronisation. What it reaches is set by each
// thread's walk over the links and by its stores: a warp's store of one
// link's value touches 32 sectors (an env's rows lie L x 13 floats apart),
// and an SM drains them for all its warps. So a block is one warp, which
// spreads 4,096 envs over 128 SMs: 15.5 us a call on an H100, against 19.1
// with 64 threads a block and 30.9 with 128.
//
// Design: one thread a batch element, kBlock threads a block. The topology
// comes in two tables packed once per topology (physics/kinematics.py::
// fk_table): an int table of (parent, joint type, dof) a link and a float
// table of (axis, jp_pos, jp_quat, jc_pos, jc_quat) a link; every thread of a
// warp reads the same row, a broadcast. The link just written stays in
// registers, where a chain finds its parent; any other parent's pose and
// velocity are read back from the thread's own output rows, written before.
// So no link count is fixed at compile time and no size limit is needed.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 32;  // one warp a block: the stores spread over the most SMs
constexpr int kInts = 3;     // parent, joint type, dof
constexpr int kFloats = 17;  // axis 3, jp_pos 3, jp_quat 4, jc_pos 3, jc_quat 4
constexpr int kJtRoot = 0, kJtRevolute = 1, kJtPrismatic = 2;  // core/scene.py JT_*

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

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

// math/quat.py::quat_rotate: v + w t + qv x t, t = 2 (qv x v)
__device__ __forceinline__ V3 rotate(Q4 q, V3 v) {
  const V3 qv{q.x, q.y, q.z};
  const V3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, q.w)), cross(qv, t));
}

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ Q4 ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ V3 ldg3(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}
__device__ __forceinline__ Q4 ldg4(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}
__device__ __forceinline__ void st3(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
__device__ __forceinline__ void st4(float* p, Q4 q) {
  p[0] = q.x; p[1] = q.y; p[2] = q.z; p[3] = q.w;
}

__global__ void __launch_bounds__(kBlock) fk_links(
    const int* __restrict__ ints, const float* __restrict__ floats, int L, int D,
    long long B, const float* __restrict__ root_pos, const float* __restrict__ root_quat,
    const float* __restrict__ root_lin, const float* __restrict__ root_ang,
    const float* __restrict__ dof_pos, const float* __restrict__ dof_vel,
    float* pos, float* quat, float* lin, float* ang) {
  const long long b = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  // this element's output rows: the parents' values are read back from them
  pos += b * L * 3;
  quat += b * L * 4;
  lin += b * L * 3;
  ang += b * L * 3;
  const float* q = dof_pos + b * D;
  const float* qd = dof_vel + b * D;
  // the last link written, kept in registers: in a chain it is the parent
  V3 last_pos{}, last_lin{}, last_ang{};
  Q4 last_quat{};
  for (int i = 0; i < L; ++i) {
    const int* ti = ints + kInts * i;
    const int jt = __ldg(ti + 1);
    if (jt == kJtRoot) {
      last_pos = ldg3(root_pos + 3 * b);
      last_quat = ldg4(root_quat + 4 * b);
      last_lin = ldg3(root_lin + 3 * b);
      last_ang = ldg3(root_ang + 3 * b);
      st3(pos + 3 * i, last_pos);
      st4(quat + 4 * i, last_quat);
      st3(lin + 3 * i, last_lin);
      st3(ang + 3 * i, last_ang);
      continue;
    }
    const int p = __ldg(ti);
    const float* tf = floats + kFloats * i;
    const V3 axis = ldg3(tf), jp_pos = ldg3(tf + 3), jc_pos = ldg3(tf + 10);
    const Q4 jp_quat = ldg4(tf + 6), jc_quat = ldg4(tf + 13);
    V3 pp = last_pos, pl = last_lin, pa = last_ang;
    Q4 pq = last_quat;
    if (p != i - 1) {  // a branch: read the parent back from its output row
      pp = ld3(pos + 3 * p);
      pq = ld4(quat + 4 * p);
      pl = ld3(lin + 3 * p);
      pa = ld3(ang + 3 * p);
    }

    const V3 jf_pos = add(pp, rotate(pq, jp_pos));
    const Q4 jf_quat = qmul(pq, jp_quat);
    V3 body_pos, w, v;
    Q4 body_quat;
    if (jt == kJtRevolute) {
      const int d = __ldg(ti + 2);
      const float half = 0.5f * __ldg(q + d);
      const float s = sinf(half), c = cosf(half);
      const Q4 post = qmul(jf_quat, Q4{axis.x * s, axis.y * s, axis.z * s, c});
      const V3 axis_w = rotate(jf_quat, axis);
      body_quat = qmul(post, jc_quat);
      body_pos = add(jf_pos, rotate(post, jc_pos));
      const V3 aq = scale(axis_w, __ldg(qd + d));
      w = add(pa, aq);
      v = add(add(pl, cross(pa, sub(jf_pos, pp))), cross(aq, sub(body_pos, jf_pos)));
    } else if (jt == kJtPrismatic) {
      const int d = __ldg(ti + 2);
      const V3 axis_w = rotate(jf_quat, axis);
      body_quat = qmul(jf_quat, jc_quat);
      body_pos = add(add(jf_pos, scale(axis_w, __ldg(q + d))), rotate(jf_quat, jc_pos));
      w = pa;
      v = add(add(pl, cross(pa, sub(body_pos, pp))), scale(axis_w, __ldg(qd + d)));
    } else {  // fixed
      body_quat = qmul(jf_quat, jc_quat);
      body_pos = add(jf_pos, rotate(jf_quat, jc_pos));
      w = pa;
      v = add(pl, cross(pa, sub(body_pos, pp)));
    }
    last_pos = body_pos;
    last_quat = body_quat;
    last_lin = v;
    last_ang = w;
    st3(pos + 3 * i, body_pos);
    st4(quat + 4 * i, body_quat);
    st3(lin + 3 * i, v);
    st3(ang + 3 * i, w);
  }
}

}  // namespace

// Launches fk_links on `stream`. Every array is contiguous: ints (L, 3) int32
// and floats (L, 17) f32, the topology's tables; root_pos (B, 3), root_quat
// (B, 4), root_lin (B, 3), root_ang (B, 3), dof_pos and dof_vel (B, D) f32;
// outputs pos (B, L, 3), quat (B, L, 4), lin (B, L, 3), ang (B, L, 3) f32.
// Returns cudaGetLastError() after the launch: 0 if it was accepted.
extern "C" int fk_forward(
    const int* ints, const float* floats, int L, int D, long long B,
    const float* root_pos, const float* root_quat, const float* root_lin,
    const float* root_ang, const float* dof_pos, const float* dof_vel,
    float* pos, float* quat, float* lin, float* ang, void* stream) {
  if (L <= 0 || D < 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fk_links<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      ints, floats, L, D, B, root_pos, root_quat, root_lin, root_ang, dof_pos, dof_vel,
      pos, quat, lin, ang);
  return (int)cudaGetLastError();
}
