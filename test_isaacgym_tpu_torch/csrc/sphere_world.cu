// Sparse-contact sphere-world solve for Hopper (sm_90a): a broadphase that
// tests each candidate pair once, then every Jacobi sweep in one launch.
//
// Replaces the Pallas TPU kernel test_isaacgym_tpu/ops/sphere_world.py
// `_pallas_solve` / `_sw_kernel`. It computes what the plain version
// `_jnp_solve` (and its torch twin `_torch_solve`) computes, and departs from
// the TPU kernel in two places on purpose:
//   * the pre-solve relative normal velocity vn0 keeps the angular term
//     (r_a w_a + r_b w_b) x n; the TPU kernel drops it;
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
// What bounds it on this card. Positions do not move during the solve, so
// the narrowphase is a distance test of every allowed pair, once, and the
// sweeps touch only the live pairs: at F = 1080 on a pile, 962 of 582,660
// pairs (~1.8 per sphere). The data's bound is reading the mask and the
// inputs once, well under a microsecond; what a kernel can reach is set by
// the candidate test (1.17 M candidates at F = 1080) and the mask bytes, both
// once per solve, then by latency: two launches, and `iters` sweeps that are
// each a few chains of dependent arithmetic behind two barriers.
//
// Design: two launches per solve.
//   1. sw_broadphase, grid (ceil(F / 4), N): 4 sphere rows a block, 2 warps
//      a row. Each block stages the world's positions and radii in shared
//      memory in tiles of kTile spheres (F = 1080 is one 17 KB tile). The
//      symmetric allow mask comes bit-packed, F rows of ceil(F / 32) uint32
//      words, packed once per spec by the wrapper: one word answers 32
//      candidates of a warp, the distance test reads shared memory (a
//      squared-distance filter with a margin spares the square root of
//      distant pairs), and __ballot_sync + __popc list the live neighbours
//      of row i in ascending order, with no atomics; a row's two warps take
//      the two halves of a tile's words and place their lists one after the
//      other, a 2-byte neighbour index an entry (F <= 32768 < 2^16). Row i's
//      list sits in device memory at row_start[i], a CSR over the ALLOWED
//      pairs, so the scratch holds the worst case (every allowed pair live)
//      and no contact is dropped; its live count goes to row_cnt.
//   2. sw_sweeps, one thread-block cluster per world: C = min(8, ceil(F /
//      128)) blocks of 512 threads, block r owning rows [r R, (r + 1) R),
//      R = ceil(F / C). It is launched as a programmatic dependent of the
//      broadphase: its blocks may start while the broadphase runs, set up
//      what the inputs alone give, then wait for the broadphase's grid
//      (griddepcontrol). All `iters` sweeps run in this one launch:
//      * each block keeps its rows' v and w in shared memory, in two buffers
//        (previous sweep, this sweep); another block's rows are read from
//        distributed shared memory (cluster.map_shared_rank), and
//        cluster.sync() is the Jacobi barrier between sweeps;
//      * its rows' per-sphere state (mass split, r, 1/m, 1/I, ground terms
//        and impulses: a 56-byte `Row`) sits in shared memory when it fits
//        beside the velocities, else in device memory;
//      * where the block's live entries fit too (the pile), a thread an
//        entry writes each entry's static data once into shared memory
//        (canonical normal, target velocity tvn from the pre-solve
//        velocities, k_n, k_t, mu mix, radii, impulses: an 80-byte `Pair`).
//        A sweep is then two phases: one thread per live ENTRY computes the
//        pair's impulse update and stores its contribution (signed impulse,
//        n x impulse) in the entry; a block barrier; one thread per ROW sums
//        its entries' contributions in ascending order of the neighbour and
//        applies the mass split and the ground contact. The chain of a sweep
//        is one pair and one row long, however many contacts a sphere has;
//      * where they do not fit (the spill path, decided by each block on the
//        data), one thread per ROW walks its list in ascending order in each
//        sweep, recomputes each entry's static data from the inputs, and
//        keeps only the entry's lam_n, lam_t in device memory, at the
//        entry's place in the CSR. So the worst-case scratch is 10 bytes an
//        allowed ordered pair (index and two impulses), not a full Pair.
//   Every pair is evaluated by both of its rows' entries in canonical order
//   (a = the lower index), from the same inputs, so both get bitwise the
//   same impulse and each keeps its own copy of the pair's lam. No float
//   atomics; results repeat bitwise from run to run.
//   The on-chip layout limits F: the two velocity buffers of R <= 4096 rows
//   take 196,608 bytes of the 232,416 a block may have, so F <= kMaxF =
//   8 * 4096 = 32768. sw_solve refuses a larger F.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBroadRows = 4;  // broadphase: rows per block
constexpr int kRowWarps = 2;   // broadphase: warps per row
constexpr int kBroadThreads = kBroadRows * kRowWarps * kWarp;
constexpr int kTile = 2048;    // broadphase: spheres staged per tile (32 KB)
constexpr int kLiveCap = kTile / kRowWarps;  // a warp's candidates in a tile
constexpr int kBroadSmem = kTile * 16 + kBroadRows * kRowWarps * kLiveCap * 4;
static_assert(kTile / kWarp <= kRowWarps * kWarp, "a lane holds one mask word of its warp's share");
constexpr int kThreads = 512;  // sweeps: threads per block
constexpr int kClusterRows = 128;  // sweeps: rows per block before C grows
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxRows = 4096;     // rows a sweeps block owns at most
constexpr int kMaxF = kMaxCluster * kMaxRows;
constexpr float kBeta = 0.2f;
constexpr float kRelax = 0.8f;

struct Scalars {
  int F;
  float h_inv, contact_offset, slop, bounce_thresh;
  float pnx, pny, pnz, pd, pf, pr;
  int has_ground;
};

struct World {  // per-world views of the inputs (offset by the kernels)
  const float* pos;
  const float* vel;
  const float* omega;
  const float* radius;
  const float* inv_m;
  const float* inv_i;
  const float* mu;
  const float* rest;

  __device__ __forceinline__ void offset(size_t w0) {
    pos += 3 * w0;
    vel += 3 * w0;
    omega += 3 * w0;
    radius += w0;
    inv_m += w0;
    inv_i += w0;
    mu += w0;
    rest += w0;
  }
};

// one live entry of row i's list: the pair (i, j)'s data in canonical order
// (a = lower index), the same bits in both rows' entries
struct __align__(16) Pair {
  int i, j;
  float nx, ny, nz;  // normal b -> a
  float tvn, kn, kt, mu;
  float ra, rb;      // radii of a and b
  float lam, lamt;   // accumulated normal and friction impulse
  float c[6];        // this sweep's contribution to row i: signed impulse, n x impulse
  int slot;          // j's sweeps block (high 16 bits), its offset in that block's v, w
};
static_assert(sizeof(Pair) == 80, "Pair is five 16-byte words");

// per-sphere state of the sweeps that only the owning thread reads
struct Row {
  Pair* list;  // live entries in shared memory (unused on the spill path)
  int n, act_g;
  float s, r, im, ii;          // 1 / contact count, radius, 1/m, 1/I
  float tvn_g, kng, ktg, mug;  // ground contact terms
  float lg, ltg;               // ground impulses
};
static_assert(sizeof(Row) == 56, "Row layout");

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

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

__device__ __forceinline__ float pair_dist(float4 a, float4 b) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  return fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-9f);
}

// static data of live pair (i, j), computed in canonical order so that rows
// i and j write the same bits; me / o hold (x, y, z, r) of i / j
__device__ Pair make_pair(const World& W, const Scalars& S, int i, int j,
                          float4 me, float4 o, int R) {
  const bool lower = i < j;
  const int ia = lower ? i : j, ib = lower ? j : i;
  const float4 a = lower ? me : o, b = lower ? o : me;
  const float dist = pair_dist(a, b);
  const float depth = (a.w + b.w) - dist;
  Pair p;
  p.i = i;
  p.j = j;
  p.nx = (a.x - b.x) / dist;
  p.ny = (a.y - b.y) / dist;
  p.nz = (a.z - b.z) / dist;
  const float ima = W.inv_m[ia], imb = W.inv_m[ib];
  const float iia = W.inv_i[ia], iib = W.inv_i[ib];
  p.mu = 0.5f * (W.mu[ia] + W.mu[ib]);
  const float rest_p = 0.5f * (W.rest[ia] + W.rest[ib]);
  p.kn = 1.f / fmaxf(ima + imb, 1e-9f);
  p.kt = 1.f / fmaxf(ima + imb + a.w * a.w * iia + b.w * b.w * iib, 1e-9f);
  float rx, ry, rz;
  relvel(W.vel[3 * ia], W.vel[3 * ia + 1], W.vel[3 * ia + 2],
         W.vel[3 * ib], W.vel[3 * ib + 1], W.vel[3 * ib + 2],
         a.w * W.omega[3 * ia] + b.w * W.omega[3 * ib],
         a.w * W.omega[3 * ia + 1] + b.w * W.omega[3 * ib + 1],
         a.w * W.omega[3 * ia + 2] + b.w * W.omega[3 * ib + 2],
         p.nx, p.ny, p.nz, rx, ry, rz);
  const float vn0 = rx * p.nx + ry * p.ny + rz * p.nz;
  const float bias = kBeta * S.h_inv * fmaxf(depth - S.slop, 0.f);
  const float bounce = vn0 < -S.bounce_thresh ? -rest_p * vn0 : 0.f;
  p.tvn = depth > S.slop ? fmaxf(bias, bounce) : (depth - S.slop) * S.h_inv;
  p.ra = a.w;
  p.rb = b.w;
  p.lam = 0.f;
  p.lamt = 0.f;
  const int owner = j / R;
  p.slot = (owner << 16) | (6 * (j - owner * R));
  return p;
}

__device__ __forceinline__ float4 sphere(const World& W, int i) {
  return make_float4(W.pos[3 * i], W.pos[3 * i + 1], W.pos[3 * i + 2], W.radius[i]);
}

// one sweep's update of pair q seen from row q.i, whose v, w are mv and j's
// are ov: the accumulated impulses lam, lamt in place, and the contribution
// to row i (signed impulse, n x impulse) in c
__device__ __forceinline__ void pair_update(const Pair& q, const float* mv, const float* ov,
                                            float& lam, float& lamt, float c[6]) {
  const bool lower = q.i < q.j;  // row i is side a of the pair
  const float mvx = mv[0], mvy = mv[1], mvz = mv[2];
  const float mwx = mv[3], mwy = mv[4], mwz = mv[5];
  const float ovx = ov[0], ovy = ov[1], ovz = ov[2];
  const float owx = ov[3], owy = ov[4], owz = ov[5];
  const float vax = lower ? mvx : ovx, vay = lower ? mvy : ovy, vaz = lower ? mvz : ovz;
  const float vbx = lower ? ovx : mvx, vby = lower ? ovy : mvy, vbz = lower ? ovz : mvz;
  const float wax = lower ? mwx : owx, way = lower ? mwy : owy, waz = lower ? mwz : owz;
  const float wbx = lower ? owx : mwx, wby = lower ? owy : mwy, wbz = lower ? owz : mwz;
  float rx, ry, rz;
  relvel(vax, vay, vaz, vbx, vby, vbz,
         q.ra * wax + q.rb * wbx, q.ra * way + q.rb * wby, q.ra * waz + q.rb * wbz,
         q.nx, q.ny, q.nz, rx, ry, rz);
  const float vn = rx * q.nx + ry * q.ny + rz * q.nz;
  const float new_lam = fmaxf(lam + kRelax * q.kn * (q.tvn - vn), 0.f);
  const float dlam = new_lam - lam;
  const float vtx = rx - vn * q.nx, vty = ry - vn * q.ny, vtz = rz - vn * q.nz;
  const float vtn = fmaxf(sqrtf(vtx * vtx + vty * vty + vtz * vtz), 1e-9f);
  const float tx = vtx / vtn, ty = vty / vtn, tz = vtz / vtn;
  const float new_lamt = fminf(lamt + kRelax * q.kt * vtn, q.mu * new_lam);
  const float dlamt = new_lamt - lamt;
  // impulse on a (b gets its negative); torque term n x imp is the same for
  // both sides: tau = -r (n x imp) on a and on b
  const float ix = dlam * q.nx - dlamt * tx;
  const float iy = dlam * q.ny - dlamt * ty;
  const float iz = dlam * q.nz - dlamt * tz;
  const float sgn = lower ? 1.f : -1.f;
  lam = new_lam;
  lamt = new_lamt;
  c[0] = sgn * ix;
  c[1] = sgn * iy;
  c[2] = sgn * iz;
  c[3] = q.ny * iz - q.nz * iy;
  c[4] = q.nz * ix - q.nx * iz;
  c[5] = q.nx * iy - q.ny * ix;
}

__global__ void __launch_bounds__(kBroadThreads)
sw_broadphase(World W, const uint32_t* __restrict__ bits,
              const int* __restrict__ row_start, int* __restrict__ row_cnt,
              uint16_t* __restrict__ nbs, long long E, Scalars S) {
  extern __shared__ __align__(16) unsigned char bsmem[];
  __shared__ int part_cnt[kBroadRows][kRowWarps];
  float4* const tile = reinterpret_cast<float4*>(bsmem);
  const int F = S.F;
  const int words = (F + kWarp - 1) / kWarp;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int rl = warp / kRowWarps, part = warp % kRowWarps;
  int* const buf = reinterpret_cast<int*>(bsmem + kTile * sizeof(float4)) + warp * kLiveCap;
  const int i = blockIdx.x * kBroadRows + rl;
  const bool has_row = i < F;  // per warp: the whole warp agrees
  const size_t w0 = (size_t)blockIdx.y * F;
  W.offset(w0);
  uint16_t* out = nbs + (size_t)blockIdx.y * E + (has_row ? row_start[i] : 0);
  const uint32_t* mrow = bits + (size_t)(has_row ? i : 0) * words;
  const float4 me = has_row ? sphere(W, i) : make_float4(0.f, 0.f, 0.f, 0.f);
  // let the sweeps kernel start its input-only set-up now (it waits for
  // this grid's results before it reads them)
  asm volatile("griddepcontrol.launch_dependents;");
  int cnt = 0;  // entries of row i written
  for (int t0 = 0; t0 < F; t0 += kTile) {
    const int tn = min(kTile, F - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < tn; k += kBroadThreads) tile[k] = sphere(W, t0 + k);
    __syncthreads();
    // the row's kRowWarps warps split the tile's mask words in order; each
    // lists its live neighbours, ascending, in its buffer
    int nbuf = 0;
    if (has_row) {
      const int tw = (tn + kWarp - 1) / kWarp, per = (tw + kRowWarps - 1) / kRowWarps;
      const int wa = t0 / kWarp + min(tw, part * per);
      const int nw = t0 / kWarp + min(tw, (part + 1) * per) - wa;  // <= 16
      const uint32_t word = lane < nw ? mrow[wa + lane] : 0u;
      for (int q = 0; q < nw; ++q) {
        const uint32_t m = __shfl_sync(kFull, word, q);
        if (m == 0u) continue;  // uniform across the warp
        const int j = (wa + q) * kWarp + lane;
        bool live = false;
        if ((m >> lane) & 1u) {  // allowed: j < F and j != i
          const float4 o = tile[j - t0];
          // a pair farther apart than its reach by a margin of 1e-4 of the
          // squared reach cannot pass the exact test; the rest take it
          const float dx = me.x - o.x, dy = me.y - o.y, dz = me.z - o.z;
          const float reach = me.w + o.w + S.contact_offset;
          if (reach > 0.f && dx * dx + dy * dy + dz * dz <= 1.0001f * reach * reach) {
            const bool lower = i < j;
            const float dist = pair_dist(lower ? me : o, lower ? o : me);
            live = (me.w + o.w) - dist > -S.contact_offset;
          }
        }
        const uint32_t ballot = __ballot_sync(kFull, live);
        if (live) buf[nbuf + __popc(ballot & ((1u << lane) - 1u))] = j;
        nbuf += __popc(ballot);
      }
    }
    if (lane == 0) part_cnt[rl][part] = nbuf;
    __syncthreads();
    // write the entries after those of the row's earlier warps
    if (has_row) {
      int before = 0, all = 0;
      for (int p = 0; p < kRowWarps; ++p) {
        const int c = part_cnt[rl][p];
        before += p < part ? c : 0;
        all += c;
      }
      for (int l = lane; l < nbuf; l += kWarp) out[cnt + before + l] = (uint16_t)buf[l];
      cnt += all;
    }
  }
  if (has_row && part == 0 && lane == 0) row_cnt[w0 + i] = cnt;
}

// exclusive prefix of x over the block, and the block's total
__device__ __forceinline__ int block_scan(int x, int* warp_tot, int& total) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  int inc = x;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == kWarp - 1) warp_tot[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kThreads / kWarp; ++w) {
    const int t = warp_tot[w];
    if (w < warp) before += t;
    total += t;
  }
  return before + inc - x;
}

// the row k of block entry e: off[k] <= e < off[k + 1], off[nr] = total
__device__ __forceinline__ int entry_row(const int* off, int nr, int e) {
  int lo = 0, hi = nr;  // off[lo] <= e < off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

// one block an SM (its shared memory allows no second): the registers of two
// are not kept free
__global__ void __launch_bounds__(kThreads, 1)
sw_sweeps(World W, const int* __restrict__ row_start, const int* __restrict__ row_cnt,
          const uint16_t* __restrict__ nbs, float2* __restrict__ lams, long long E, Row* grows,
          float* __restrict__ v_out, float* __restrict__ w_out,
          float* __restrict__ cf_out, Scalars S, int iters, int R, int smem_bytes) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[kThreads / kWarp];
  const int F = S.F;
  const int rank = (int)cluster.block_rank();
  const size_t w0 = (size_t)blockIdx.y * F;
  W.offset(w0);
  const int r0 = rank * R;
  const int nr = max(0, min(R, F - r0));
  const int rpt = (nr + kThreads - 1) / kThreads;
  const int k0 = min(nr, (int)threadIdx.x * rpt), k1 = min(nr, k0 + rpt);

  // shared memory: v, w of R rows twice (6 floats a row); the entry offsets
  // of the rows; the Rows if they fit; the entries if they fit
  float* vw = reinterpret_cast<float*>(smem);
  const int vw_bytes = 2 * R * 6 * (int)sizeof(float);
  int* off = reinterpret_cast<int*>(smem + vw_bytes);
  const int rows_at = align16(vw_bytes + (R + 1) * (int)sizeof(int));
  const int rows_bytes = nr * (int)sizeof(Row);
  const bool rows_fit = rows_at + rows_bytes <= smem_bytes;
  Row* rows = rows_fit ? reinterpret_cast<Row*>(smem + rows_at) : grows + w0 + r0;
  const int pairs_at = align16(rows_at + (rows_fit ? rows_bytes : 0));
  Pair* const spairs = reinterpret_cast<Pair*>(smem + pairs_at);
  const uint16_t* const gnb = nbs + (size_t)blockIdx.y * E;
  float2* const glam = lams + (size_t)blockIdx.y * E;

  // set-up from the inputs alone, while the broadphase may still run
  for (int k = k0; k < k1; ++k) {
    const int i = r0 + k;
    Row rw;
    rw.r = W.radius[i];
    rw.im = W.inv_m[i];
    rw.ii = W.inv_i[i];
    const float vx = W.vel[3 * i], vy = W.vel[3 * i + 1], vz = W.vel[3 * i + 2];
    // ground contact of sphere i (geometry is static during the solve)
    const float dg = W.pos[3 * i] * S.pnx + W.pos[3 * i + 1] * S.pny
                     + W.pos[3 * i + 2] * S.pnz - S.pd;
    const float depth_g = rw.r - dg;
    rw.act_g = S.has_ground && depth_g > -S.contact_offset;
    const float vn0g = vx * S.pnx + vy * S.pny + vz * S.pnz;
    const float bias_g = kBeta * S.h_inv * fmaxf(depth_g - S.slop, 0.f);
    const float rest_g = 0.5f * (W.rest[i] + S.pr);
    const float bounce_g = vn0g < -S.bounce_thresh ? -rest_g * vn0g : 0.f;
    rw.tvn_g = depth_g > S.slop ? fmaxf(bias_g, bounce_g) : (depth_g - S.slop) * S.h_inv;
    rw.kng = 1.f / fmaxf(rw.im, 1e-9f);
    rw.ktg = 1.f / fmaxf(rw.im + rw.r * rw.r * rw.ii, 1e-9f);
    rw.mug = 0.5f * (W.mu[i] + S.pf);
    rw.lg = 0.f;
    rw.ltg = 0.f;
    rows[k] = rw;
    float* v0 = vw + 6 * k;
    v0[0] = vx;
    v0[1] = vy;
    v0[2] = vz;
    v0[3] = W.omega[3 * i];
    v0[4] = W.omega[3 * i + 1];
    v0[5] = W.omega[3 * i + 2];
  }

  // the broadphase's lists: wait for its grid, then place them
  asm volatile("griddepcontrol.wait;" ::: "memory");
  int mine = 0;
  for (int k = k0; k < k1; ++k) mine += row_cnt[w0 + r0 + k];
  int total;
  int o = block_scan(mine, warp_tot, total);
  if (threadIdx.x == 0) off[nr] = total;
  const bool pairs_fit = (long long)pairs_at + (long long)total * (long long)sizeof(Pair) <= smem_bytes;
  for (int k = k0; k < k1; ++k) {
    const int n = row_cnt[w0 + r0 + k];
    const int start = row_start[r0 + k];
    off[k] = o;
    rows[k].n = n;
    rows[k].s = 1.f / fmaxf((float)(n + rows[k].act_g), 1.f);
    rows[k].list = spairs + o;
    if (!pairs_fit)
      for (int p = 0; p < n; ++p) glam[start + p] = make_float2(0.f, 0.f);
    o += n;
  }
  __syncthreads();  // off[] complete
  if (pairs_fit) {
    // each entry's static data, once, a thread an entry
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int k = entry_row(off, nr, e);
      const int i = r0 + k, j = gnb[row_start[i] + (e - off[k])];
      spairs[e] = make_pair(W, S, i, j, sphere(W, i), sphere(W, j), R);
    }
  }
  cluster.sync();

  const float pnx = S.pnx, pny = S.pny, pnz = S.pnz;
  for (int it = 0; it < iters; ++it) {
    float* cur = vw + (it & 1) * R * 6;
    float* nxt = vw + ((it & 1) ^ 1) * R * 6;
    const bool last = it == iters - 1;
    // phase 1 (entries in shared memory): one thread per live entry (i, j)
    for (int e = threadIdx.x; e < (pairs_fit ? total : 0); e += kThreads) {
      Pair* qp = spairs + e;
      const Pair q = *qp;
      const float* ov = cluster.map_shared_rank(cur + (q.slot & 0xffff), (unsigned)q.slot >> 16);
      float lam = q.lam, lamt = q.lamt;
      pair_update(q, cur + 6 * (q.i - r0), ov, lam, lamt, qp->c);
      qp->lam = lam;
      qp->lamt = lamt;
    }
    __syncthreads();
    // phase 2: one thread per row: its entries in ascending j, then ground
    for (int k = k0; k < k1; ++k) {
      const int i = r0 + k;
      Row rw = rows[k];
      const float* mv = cur + 6 * k;
      float six = 0.f, siy = 0.f, siz = 0.f;
      float sqx = 0.f, sqy = 0.f, sqz = 0.f;
      float scx = 0.f, scy = 0.f, scz = 0.f;  // normal force, last sweep
      if (pairs_fit) {
#pragma unroll 4
        for (int p = 0; p < rw.n; ++p) {
          const float* c = rw.list[p].c;
          six += c[0];
          siy += c[1];
          siz += c[2];
          sqx += c[3];
          sqy += c[4];
          sqz += c[5];
        }
        if (last) {
          for (int p = 0; p < rw.n; ++p) {
            const Pair& q = rw.list[p];
            const float sl = (i < q.j ? 1.f : -1.f) * q.lam;
            scx += sl * q.nx;
            scy += sl * q.ny;
            scz += sl * q.nz;
          }
        }
      } else {
        // spill path: the row's entries one after the other, their static
        // data recomputed, their impulses in device memory
        const uint16_t* nb = gnb + row_start[i];
        float2* lm = glam + row_start[i];
        const float4 me = sphere(W, i);
        for (int p = 0; p < rw.n; ++p) {
          const int j = nb[p];
          const Pair q = make_pair(W, S, i, j, me, sphere(W, j), R);
          const float* ov = cluster.map_shared_rank(cur + (q.slot & 0xffff), (unsigned)q.slot >> 16);
          float2 l = lm[p];
          float c[6];
          pair_update(q, mv, ov, l.x, l.y, c);
          lm[p] = l;
          six += c[0];
          siy += c[1];
          siz += c[2];
          sqx += c[3];
          sqy += c[4];
          sqz += c[5];
          const float sl = (i < j ? 1.f : -1.f) * l.x;
          scx += sl * q.nx;
          scy += sl * q.ny;
          scz += sl * q.nz;
        }
      }
      const float sv = rw.im * rw.s, sw = -rw.r * rw.ii * rw.s;
      float vx = mv[0] + six * sv, vy = mv[1] + siy * sv, vz = mv[2] + siz * sv;
      float wx = mv[3] + sqx * sw, wy = mv[4] + sqy * sw, wz = mv[5] + sqz * sw;
      float lg_new = 0.f;
      if (S.has_ground) {
        // vr = v - (w x n) r
        const float rx = vx - (wy * pnz - wz * pny) * rw.r;
        const float ry = vy - (wz * pnx - wx * pnz) * rw.r;
        const float rz = vz - (wx * pny - wy * pnx) * rw.r;
        const float vng = rx * pnx + ry * pny + rz * pnz;
        const float lg = rw.lg, ltg = rw.ltg;
        const float dlg = rw.act_g ? fmaxf(lg + kRelax * rw.kng * (rw.tvn_g - vng), 0.f) - lg : 0.f;
        lg_new = lg + dlg;
        const float vtx = rx - vng * pnx, vty = ry - vng * pny, vtz = rz - vng * pnz;
        const float vtn = fmaxf(sqrtf(vtx * vtx + vty * vty + vtz * vtz), 1e-9f);
        const float dltg = rw.act_g ? fminf(ltg + kRelax * rw.ktg * vtn, rw.mug * lg_new) - ltg : 0.f;
        rows[k].lg = lg_new;
        rows[k].ltg = ltg + dltg;
        const float gx = dlg * pnx - dltg * (vtx / vtn);
        const float gy = dlg * pny - dltg * (vty / vtn);
        const float gz = dlg * pnz - dltg * (vtz / vtn);
        vx += gx * sv;
        vy += gy * sv;
        vz += gz * sv;
        // tau = (-n r) x imp_g
        const float arx = -pnx * rw.r, ary = -pny * rw.r, arz = -pnz * rw.r;
        const float swg = rw.ii * rw.s;
        wx += (ary * gz - arz * gy) * swg;
        wy += (arz * gx - arx * gz) * swg;
        wz += (arx * gy - ary * gx) * swg;
      }
      if (last) {
        // net normal contact force: both sides' normal impulses + ground
        const size_t o3 = 3 * (w0 + i);
        v_out[o3] = vx;
        v_out[o3 + 1] = vy;
        v_out[o3 + 2] = vz;
        w_out[o3] = wx;
        w_out[o3 + 1] = wy;
        w_out[o3 + 2] = wz;
        const float g = rw.act_g ? lg_new : 0.f;
        cf_out[o3] = (scx + g * pnx) * S.h_inv;
        cf_out[o3 + 1] = (scy + g * pny) * S.h_inv;
        cf_out[o3 + 2] = (scz + g * pnz) * S.h_inv;
      } else {
        float* nv = nxt + 6 * k;
        nv[0] = vx;
        nv[1] = vy;
        nv[2] = vz;
        nv[3] = wx;
        nv[4] = wy;
        nv[5] = wz;
      }
    }
    // the Jacobi barrier; after the last sweep it keeps this block's shared
    // memory alive until every block of the cluster has read it
    cluster.sync();
  }
}

}  // namespace

// Largest F the kernel takes (its on-chip layout; see the note above).
extern "C" int sw_max_spheres() { return kMaxF; }

// Launches the broadphase and the sweeps on `stream`. Arrays are contiguous:
// f32 (N, F, 3) or (N, F); allow_bits (F, ceil(F / 32)) uint32 of the
// symmetric mask; row_start (F + 1) int32, the CSR offsets of each row's
// allowed pairs, n_entries = row_start[F]. Scratch, 16-byte aligned: row_cnt
// (N, F) int32, rows N * F * 56 bytes, lams (N, n_entries) float2, nbs
// (N, n_entries) uint16: 10 bytes an allowed ordered pair, 60 a sphere.
// Returns the first non-zero CUDA error of the launches, else 0.
extern "C" int sw_solve(
    const float* pos, const float* vel, const float* omega,
    const float* radius, const float* inv_m, const float* inv_i,
    const float* mu, const float* rest,
    const uint32_t* allow_bits, const int* row_start, long long n_entries,
    int* row_cnt, void* rows, void* lams, void* nbs,
    float* vel_out, float* omega_out, float* cf_out,
    int N, int F, int iters,
    float h, float contact_offset, float slop, float bounce_thresh,
    float pnx, float pny, float pnz, float pd, float pf, float pr,
    int has_ground, void* stream) {
  if (N <= 0 || F <= 0 || F > kMaxF || iters <= 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Scalars S{F, 1.f / h, contact_offset, slop, bounce_thresh,
            pnx, pny, pnz, pd, pf, pr, has_ground};
  World W{pos, vel, omega, radius, inv_m, inv_i, mu, rest};
  uint16_t* NB = static_cast<uint16_t*>(nbs);

  // the dynamic shared memory a sweeps block may take on this device: the
  // opt-in maximum less the kernel's static shared memory (232,416 bytes on
  // an H100), looked up and granted once per device
  static int smem_max[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_max[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, sw_sweeps);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sw_sweeps, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(sw_broadphase, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBroadSmem);
    if (e != cudaSuccess) return (int)e;
    smem_max[dev] = optin - (int)fa.sharedSizeBytes;
  }
  const int C = min(kMaxCluster, (F + kClusterRows - 1) / kClusterRows);
  const int R = (F + C - 1) / C;
  const int fixed = align16(2 * R * 6 * 4 + (R + 1) * 4);
  if (fixed > smem_max[dev]) return (int)cudaErrorInvalidValue;
  const long long want = fixed + R * (long long)sizeof(Row) + n_entries * (long long)sizeof(Pair);
  const int smem = (int)(want < smem_max[dev] ? want : smem_max[dev]);

  sw_broadphase<<<dim3((F + kBroadRows - 1) / kBroadRows, N), kBroadThreads, kBroadSmem, st>>>(
      W, allow_bits, row_start, row_cnt, NB, n_entries, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // may start before the broadphase ends (griddepcontrol in both kernels)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, sw_sweeps, W, row_start, (const int*)row_cnt,
                         (const uint16_t*)NB, static_cast<float2*>(lams), n_entries,
                         static_cast<Row*>(rows), vel_out, omega_out, cf_out, S, iters, R, smem);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}
