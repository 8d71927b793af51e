// Dense all-pairs sphere-world contact solve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel test_isaacgym_tpu/ops/sphere_world.py
// `_pallas_solve` / `_sw_kernel`. It computes what the plain version
// `_jnp_solve` (and its torch twin `_torch_solve`) computes, and departs from
// the TPU kernel in two places on purpose:
//   * the pre-solve relative normal velocity vn0 keeps the angular term
//     (r_i w_i + r_j w_j) x n; the TPU kernel drops it;
//   * the accumulated friction impulse lam_t is stored in f32; the TPU kernel
//     stores it in bf16 to fit VMEM.
//
// Math, per world of F spheres: every pair (a < b) with allow[a][b] and
// depth > -contact_offset is a contact with normal b -> a. Mass splitting
// divides each sphere's impulses by its number of active contacts (pairs plus
// ground). `iters` relaxed-Jacobi sweeps (relax 0.8, Baumgarte beta 0.2, slop,
// speculative target below slop, restitution from the pre-solve velocity)
// each clamp the normal impulse at >= 0, cap the scalar friction impulse at
// mu * lam_n along the instantaneous tangent, apply the summed pair impulses,
// then run one ground-plane contact per sphere. The last sweep also writes
// the normal contact force (impulse / h) per sphere.
//
// Design:
//   * One launch per sweep. A sweep needs the whole previous sweep's
//     velocities (Jacobi), so the launch boundary is the barrier between
//     sweeps; velocities ping-pong between two buffers. The mass-splitting
//     count is recomputed inside every sweep (it is one add per pair), so no
//     separate count pass is launched: `iters` launches per solve.
//   * One warp per sphere row i, 4 rows per block, grid (ceil(F/4), N). The
//     warp walks all j != i. Each row computes BOTH halves of its pairs: for
//     j > i it is side a, for j < i side b of pair (j, i). Every pair is
//     evaluated by both of its rows in the same canonical order (a = lower
//     index), so both get bitwise the same impulse. Row sums therefore stay in
//     one warp: no atomics, and the result does not change from run to run.
//   * The accumulated impulses lam_n and lam_t are kept as full symmetric
//     (F, F) f32 matrices in device memory: row i owns row i and reads and
//     writes only row i, so a single buffer is race-free and every access is
//     coalesced. At F = 1080 they are 4.7 MB each and stay in the 50 MB L2.
//     The first sweep reads no lambda (it starts at zero), so no memset.
//   * The allow mask arrives symmetric (allow | allow^T) as uint8, uploaded
//     once per spec by the wrapper. The ragged edge (F not a multiple of 4)
//     is masked by row index; F is never padded.
//
// Bound: the work the data needs is a distance test of every candidate pair
// once, and ~100 f32 operations per sweep for each ACTIVE pair only (about a
// thousand of the 582,660 pairs once 1080 balls have piled). That is less
// than reading the F x F allow mask once, so bytes bound the solve: ~0.4 us
// at F = 1080 on an H100 SXM. This kernel re-tests every pair in every sweep
// and evaluates each active pair twice; it is far above that bound and
// limited by the latency of its strided loads, not by either peak rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;
constexpr float kBeta = 0.2f;
constexpr float kRelax = 0.8f;

struct Scalars {
  int F;
  float h_inv, contact_offset, slop, bounce_thresh;
  float pnx, pny, pnz, pd, pf, pr;
  int has_ground;
};

struct World {  // per-world views of the inputs (pointers already offset)
  const float* pos;
  const float* vel0;
  const float* om0;
  const float* v;
  const float* w;
  const float* radius;
  const float* inv_m;
  const float* inv_i;
  const float* mu;
  const float* rest;
};

struct Body {
  float px, py, pz, r;
  float vx, vy, vz, wx, wy, wz;
  float v0x, v0y, v0z, w0x, w0y, w0z;
  float im, ii, mu, rest;
};

__device__ __forceinline__ void load_geom(const World& W, int k, Body& b) {
  b.px = W.pos[3 * k];
  b.py = W.pos[3 * k + 1];
  b.pz = W.pos[3 * k + 2];
  b.r = W.radius[k];
}

__device__ __forceinline__ void load_dyn(const World& W, int k, Body& b) {
  b.vx = W.v[3 * k];
  b.vy = W.v[3 * k + 1];
  b.vz = W.v[3 * k + 2];
  b.wx = W.w[3 * k];
  b.wy = W.w[3 * k + 1];
  b.wz = W.w[3 * k + 2];
  b.v0x = W.vel0[3 * k];
  b.v0y = W.vel0[3 * k + 1];
  b.v0z = W.vel0[3 * k + 2];
  b.w0x = W.om0[3 * k];
  b.w0y = W.om0[3 * k + 1];
  b.w0z = W.om0[3 * k + 2];
  b.im = W.inv_m[k];
  b.ii = W.inv_i[k];
  b.mu = W.mu[k];
  b.rest = W.rest[k];
}

// normal component of the surface relative velocity of a pair:
// vr = v_a - v_b - (r_a w_a + r_b w_b) x n, all components returned
__device__ __forceinline__ void relvel(
    float vax, float vay, float vaz, float vbx, float vby, float vbz,
    float wmx, float wmy, float wmz, float nx, float ny, float nz,
    float& rx, float& ry, float& rz) {
  const float cx = wmy * nz - wmz * ny;
  const float cy = wmz * nx - wmx * nz;
  const float cz = wmx * ny - wmy * nx;
  rx = vax - vbx - cx;
  ry = vay - vby - cy;
  rz = vaz - vbz - cz;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
sw_sweep(World W, const uint8_t* __restrict__ allow,
         float* __restrict__ lam_n, float* __restrict__ lam_t,
         float* __restrict__ lam_g, float* __restrict__ lamt_g,
         float* __restrict__ v_out, float* __restrict__ w_out,
         float* __restrict__ cf_out, Scalars S, int first, int last) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp);
  const int F = S.F;
  if (i >= F) return;  // whole warp leaves together: i is per warp

  const size_t w0 = (size_t)blockIdx.y * F;  // first body of this world
  W.pos += 3 * w0;
  W.vel0 += 3 * w0;
  W.om0 += 3 * w0;
  W.v += 3 * w0;
  W.w += 3 * w0;
  W.radius += w0;
  W.inv_m += w0;
  W.inv_i += w0;
  W.mu += w0;
  W.rest += w0;
  const size_t row = (w0 + i) * (size_t)F;
  float* ln = lam_n + row;
  float* lt = lam_t + row;
  const uint8_t* arow = allow + (size_t)i * F;

  Body me;
  load_geom(W, i, me);
  load_dyn(W, i, me);

  // row sums: signed impulse, n x impulse, signed normal impulse, count
  float six = 0.f, siy = 0.f, siz = 0.f;
  float sqx = 0.f, sqy = 0.f, sqz = 0.f;
  float scx = 0.f, scy = 0.f, scz = 0.f;
  float cnt = 0.f;

  for (int j = lane; j < F; j += kWarp) {
    if (j == i || !arow[j]) continue;
    Body other;
    load_geom(W, j, other);
    const bool lower = i < j;  // this row is side a of the pair
    // canonical order: a = lower index, so both rows compute the same bits
    const float ax = lower ? me.px : other.px, ay = lower ? me.py : other.py,
                az = lower ? me.pz : other.pz, ar = lower ? me.r : other.r;
    const float bx = lower ? other.px : me.px, by = lower ? other.py : me.py,
                bz = lower ? other.pz : me.pz, br = lower ? other.r : me.r;
    const float dx = ax - bx, dy = ay - by, dz = az - bz;
    const float dist = fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-9f);
    const float depth = (ar + br) - dist;
    if (!(depth > -S.contact_offset)) continue;
    cnt += 1.f;

    load_dyn(W, j, other);
    const Body A = lower ? me : other;
    const Body B = lower ? other : me;
    const float nx = dx / dist, ny = dy / dist, nz = dz / dist;
    const float mu_p = 0.5f * (A.mu + B.mu);
    const float rest_p = 0.5f * (A.rest + B.rest);
    const float k_n = 1.f / fmaxf(A.im + B.im, 1e-9f);
    const float k_t = 1.f / fmaxf(A.im + B.im + ar * ar * A.ii + br * br * B.ii, 1e-9f);

    float rx, ry, rz;
    relvel(A.v0x, A.v0y, A.v0z, B.v0x, B.v0y, B.v0z,
           ar * A.w0x + br * B.w0x, ar * A.w0y + br * B.w0y, ar * A.w0z + br * B.w0z,
           nx, ny, nz, rx, ry, rz);
    const float vn0 = rx * nx + ry * ny + rz * nz;
    const float bias = kBeta * S.h_inv * fmaxf(depth - S.slop, 0.f);
    const float bounce = vn0 < -S.bounce_thresh ? -rest_p * vn0 : 0.f;
    const float tvn = depth > S.slop ? fmaxf(bias, bounce) : (depth - S.slop) * S.h_inv;

    relvel(A.vx, A.vy, A.vz, B.vx, B.vy, B.vz,
           ar * A.wx + br * B.wx, ar * A.wy + br * B.wy, ar * A.wz + br * B.wz,
           nx, ny, nz, rx, ry, rz);
    const float vn = rx * nx + ry * ny + rz * nz;
    const float lam = first ? 0.f : ln[j];
    const float new_lam = fmaxf(lam + kRelax * k_n * (tvn - vn), 0.f);
    const float dlam = new_lam - lam;

    const float vtx = rx - vn * nx, vty = ry - vn * ny, vtz = rz - vn * nz;
    const float vtn = fmaxf(sqrtf(vtx * vtx + vty * vty + vtz * vtz), 1e-9f);
    const float tx = vtx / vtn, ty = vty / vtn, tz = vtz / vtn;
    const float lamt = first ? 0.f : lt[j];
    const float new_lamt = fminf(lamt + kRelax * k_t * vtn, mu_p * new_lam);
    const float dlamt = new_lamt - lamt;
    ln[j] = new_lam;
    lt[j] = new_lamt;

    // impulse on a (b gets its negative); torque term n x imp is the same
    // for both sides: tau = -r (n x imp) on a and on b
    const float ix = dlam * nx - dlamt * tx;
    const float iy = dlam * ny - dlamt * ty;
    const float iz = dlam * nz - dlamt * tz;
    const float sgn = lower ? 1.f : -1.f;
    six += sgn * ix;
    siy += sgn * iy;
    siz += sgn * iz;
    sqx += ny * iz - nz * iy;
    sqy += nz * ix - nx * iz;
    sqz += nx * iy - ny * ix;
    scx += sgn * new_lam * nx;
    scy += sgn * new_lam * ny;
    scz += sgn * new_lam * nz;
  }

  six = warp_sum(six);
  siy = warp_sum(siy);
  siz = warp_sum(siz);
  sqx = warp_sum(sqx);
  sqy = warp_sum(sqy);
  sqz = warp_sum(sqz);
  scx = warp_sum(scx);
  scy = warp_sum(scy);
  scz = warp_sum(scz);
  cnt = warp_sum(cnt);
  if (lane != 0) return;

  // ground contact of sphere i (geometry is static during the solve)
  const float pnx = S.pnx, pny = S.pny, pnz = S.pnz;
  const float dg = me.px * pnx + me.py * pny + me.pz * pnz - S.pd;
  const float depth_g = me.r - dg;
  const bool act_g = S.has_ground && depth_g > -S.contact_offset;
  if (act_g) cnt += 1.f;
  const float s = 1.f / fmaxf(cnt, 1.f);

  const float sv = me.im * s, sw = -me.r * me.ii * s;
  float vx = me.vx + six * sv, vy = me.vy + siy * sv, vz = me.vz + siz * sv;
  float wx = me.wx + sqx * sw, wy = me.wy + sqy * sw, wz = me.wz + sqz * sw;

  const size_t k = w0 + i;
  float lg_new = 0.f;
  if (S.has_ground) {
    const float vn0g = me.v0x * pnx + me.v0y * pny + me.v0z * pnz;
    const float bias_g = kBeta * S.h_inv * fmaxf(depth_g - S.slop, 0.f);
    const float rest_g = 0.5f * (me.rest + S.pr);
    const float bounce_g = vn0g < -S.bounce_thresh ? -rest_g * vn0g : 0.f;
    const float tvn_g = depth_g > S.slop ? fmaxf(bias_g, bounce_g)
                                         : (depth_g - S.slop) * S.h_inv;
    const float k_ng = 1.f / fmaxf(me.im, 1e-9f);
    const float k_tg = 1.f / fmaxf(me.im + me.r * me.r * me.ii, 1e-9f);
    // vr = v - (w x n) r
    const float rx = vx - (wy * pnz - wz * pny) * me.r;
    const float ry = vy - (wz * pnx - wx * pnz) * me.r;
    const float rz = vz - (wx * pny - wy * pnx) * me.r;
    const float vng = rx * pnx + ry * pny + rz * pnz;
    const float lg = first ? 0.f : lam_g[k];
    const float ltg = first ? 0.f : lamt_g[k];
    const float dlg = act_g ? fmaxf(lg + kRelax * k_ng * (tvn_g - vng), 0.f) - lg : 0.f;
    lg_new = lg + dlg;
    const float vtx = rx - vng * pnx, vty = ry - vng * pny, vtz = rz - vng * pnz;
    const float vtn = fmaxf(sqrtf(vtx * vtx + vty * vty + vtz * vtz), 1e-9f);
    const float mu_g = 0.5f * (me.mu + S.pf);
    const float dltg = act_g ? fminf(ltg + kRelax * k_tg * vtn, mu_g * lg_new) - ltg : 0.f;
    lam_g[k] = lg_new;
    lamt_g[k] = ltg + dltg;
    const float gx = dlg * pnx - dltg * (vtx / vtn);
    const float gy = dlg * pny - dltg * (vty / vtn);
    const float gz = dlg * pnz - dltg * (vtz / vtn);
    vx += gx * sv;
    vy += gy * sv;
    vz += gz * sv;
    // tau = (-n r) x imp_g
    const float arx = -pnx * me.r, ary = -pny * me.r, arz = -pnz * me.r;
    const float swg = me.ii * s;
    wx += (ary * gz - arz * gy) * swg;
    wy += (arz * gx - arx * gz) * swg;
    wz += (arx * gy - ary * gx) * swg;
  }
  v_out[3 * k] = vx;
  v_out[3 * k + 1] = vy;
  v_out[3 * k + 2] = vz;
  w_out[3 * k] = wx;
  w_out[3 * k + 1] = wy;
  w_out[3 * k + 2] = wz;
  if (last) {
    const float g = act_g ? lg_new : 0.f;
    cf_out[3 * k] = (scx + g * pnx) * S.h_inv;
    cf_out[3 * k + 1] = (scy + g * pny) * S.h_inv;
    cf_out[3 * k + 2] = (scz + g * pnz) * S.h_inv;
  }
}

}  // namespace

// Launches `iters` sweeps on `stream`. Arrays are contiguous f32, (N, F, 3)
// or (N, F); allow is (F, F) uint8 and symmetric; lam_n / lam_t are (N, F, F)
// and lam_g / lamt_g (N, F) scratch; va/wa/vb/wb are (N, F, 3) scratch.
// Returns the first non-zero cudaGetLastError() of a launch, else 0.
extern "C" int sw_solve(
    const float* pos, const float* vel, const float* omega,
    const float* radius, const float* inv_m, const float* inv_i,
    const float* mu, const float* rest, const uint8_t* allow,
    float* lam_n, float* lam_t, float* lam_g, float* lamt_g,
    float* va, float* wa, float* vb, float* wb,
    float* vel_out, float* omega_out, float* cf_out,
    int N, int F, int iters,
    float h, float contact_offset, float slop, float bounce_thresh,
    float pnx, float pny, float pnz, float pd, float pf, float pr,
    int has_ground, void* stream) {
  if (N <= 0 || F <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  Scalars S{F, 1.f / h, contact_offset, slop, bounce_thresh,
            pnx, pny, pnz, pd, pf, pr, has_ground};
  const dim3 block(kRowsPerBlock * kWarp);
  const dim3 grid((F + kRowsPerBlock - 1) / kRowsPerBlock, N);
  float* sv[2] = {va, vb};
  float* sw[2] = {wa, wb};
  for (int it = 0; it < iters; ++it) {
    const bool last = it == iters - 1;
    World W{pos, vel, omega,
            it == 0 ? vel : sv[(it - 1) % 2], it == 0 ? omega : sw[(it - 1) % 2],
            radius, inv_m, inv_i, mu, rest};
    float* vo = last ? vel_out : sv[it % 2];
    float* wo = last ? omega_out : sw[it % 2];
    sw_sweep<<<grid, block, 0, (cudaStream_t)stream>>>(
        W, allow, lam_n, lam_t, lam_g, lamt_g, vo, wo, cf_out, S,
        it == 0 ? 1 : 0, last ? 1 : 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
