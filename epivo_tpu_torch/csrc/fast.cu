// FAST-9/16 corner score with fused 3x3 non-maximum suppression, and the
// fused candidate kernel: score, NMS and the first top-k stage (the best 8
// of each 16x16 block) in one launch.
//
// Replaces the TPU kernel epivo_tpu/frontend/pallas_fast.py::_fast_tile_kernel
// (entry fast_score_map_pallas), and, in fast_candidates_kernel, also the
// first stage of epivo_tpu/frontend/fast.py::top_k_keypoints, which the
// reference runs outside Pallas. Plain versions and oracles:
// epivo_tpu_torch/frontend/fast.py::fast_score_map + nms3 (dense kernel) and
// block_candidates(nms3(fast_score_map(.))) (candidate kernel).
//
// What bounds them on the H100: bytes, in principle. A 376x1241 frame is
// 1.9 MB in; the dense map is 1.9 MB out, the candidates 0.12 MB (14,976 x
// (value, index)), 0.6 us at 3.35 TB/s. With the early rejection below, the
// arithmetic this data needs is ~12 M operations (0.2 us at 67 TFLOP/s). In
// practice both kernels are bound by instruction issue and latency: every
// pixel still takes the compass test (~50 instructions per 32 pixels per
// warp), a block waits for its global load and two barriers, and the
// selection is a serial chain per 16x16 block.
//
// Design, shared by both kernels (one block of 256 threads per 32x32 output
// tile, batch in gridDim.z):
//   stage  The block copies the tile plus a 4-pixel halo (3 for the ring, 1
//          for the NMS apron) into shared memory with 4-byte cp.async, one
//          coalesced row per warp step. Coordinates are clamped to the image
//          (mode="edge"); the halo only feeds pixels that score 0 anyway
//          (the 3-pixel border), so the clamp only keeps reads in bounds.
//          Rows of an odd-width image are not 16-byte aligned, which rules
//          out wider copies and TMA.
//   score  The 34x34 tile-plus-apron is scored into shared memory, so NMS
//          never needs another block's scores. Pass 1 gives every pixel the
//          exact compass test: any 9 consecutive ring pixels contain two
//          neighbouring compass points (ring indices k and k+4 of
//          {0, 4, 8, 12}), so a pixel with no neighbouring compass pair both
//          above +t and none both below -t has score <= t and outputs 0
//          (4 % of the pixels of a corridor frame at t = 40 pass). Each warp
//          lists its passing pixels (ballot + popc, in order, no atomics);
//          after a barrier, pass 2 scores the block's whole list, 32 pixels
//          per warp at a time, so ~40 passing pixels of a tile cost two warp
//          rounds, not eight. The full score runs on one side only: on the
//          ring values for a bright-only pixel, on their negatives for a
//          dark-only one (min -S = -max S exactly), on both for the rare
//          pixel that passes both ways. Arcs are taken over the raw ring
//          values and the centre is subtracted once (x -> fl(x - c) is
//          monotone, so it commutes with min and max, bit for bit). The 16
//          arcs' minima share partial minima (pairs, quads, octets: 48 min),
//          then 16 min and a 15-max tree give the best arc: 79 min/max
//          against 16 x 8 x 2 + 31 for the naive arc loop.
//   NMS    From shared memory, as in the reference: a score survives if it
//          is >= all 8 neighbours.
// The dense kernel then writes the tile. The candidate kernel gives each of
// its four 16x16 selection blocks one warp. For NMS, lane l takes column
// l % 16 of rows 8 (l / 16) .. 8 (l / 16) + 7 (10 x 3 shared-memory reads,
// bank-conflict free with the 34-float pitch; row maxima shared between
// the rows) and stores the block in lane order p = r * 16 + c; for the
// selection, lane l takes lanes p = 8 l .. 8 l + 7, so lane order is p
// order. Each round takes the largest remaining value (one integer max
// reduction over an order-preserving key) and then every lane holding it,
// in p order: a lane's holders take consecutive slots after those of the
// lanes below it (bit-sliced ballots of each lane's count), until 8 are
// taken. Iterated first-argmax with masking to -inf (the reference) takes
// equal values consecutively in ascending p, so this is the same order,
// (value descending, p ascending), with one round per distinct value
// instead of one per candidate. The 8 candidates are staged in shared
// memory and written by 8 lanes at once. No block barrier inside the
// selection, no atomics: the order is deterministic.

// Semantics kept bit for bit (the candidate kernel):
//   - block order: row-major over the (ceil(H/16), ceil(W/16)) blocks; a
//     block's 8 candidates in (value descending, lane p ascending) order;
//   - out-of-image lanes of a ragged block take part with value 0 and
//     their own lane index, as the reference's zero padding does, so a
//     block with fewer than 8 corners fills its tail with its lowest-index
//     zero lanes, some possibly outside the image (the reference's final
//     zeroing of out-of-image candidates is then a no-op);
//   - indices are y * Wp + x in the padded frame, Wp = 16 ceil(W / 16).
// Both kernels only subtract, take min/max and compare, and any
// association of min/max is exact, so they are bit-exact with the plain
// versions on finite images. Do not build with --use_fast_math.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;                          // output tile edge
constexpr int kRing = 3;                           // FAST ring radius
constexpr int kApron = 1;                          // NMS neighbourhood
constexpr int kIn = kTile + 2 * (kRing + kApron);  // 40: staged input edge
constexpr int kSc = kTile + 2 * kApron;            // 34: scored edge
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScChunks = (kSc * kSc + kThreads - 1) / kThreads;  // 5
constexpr int kListCap = kScChunks * 32;  // passing pixels a warp can hold
constexpr int kBlk = 16;                  // selection block edge
constexpr int kCand = 8;                  // candidates per selection block

constexpr int kPer = kTile / kBlk;        // selection blocks per tile edge
constexpr int kHalfPad = kBlk * kBlk / 2 + 16;  // a block's half, padded

struct Smem {
  float in[kIn][kIn];
  float sc[kSc][kSc];
  int count[kWarps];  // passing pixels of each warp
  float out_val[kPer * kPer][kCand];  // selection: each warp's candidates
  int out_idx[kPer * kPer][kCand];
  union {
    int list[kWarps][kListCap];                  // scoring: passing pixels
    alignas(16) float blk[kPer * kPer][2 * kHalfPad];  // selection: NMS'd blocks
  };
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

// Copy rows y0 - 4 .. y0 + 35 and columns x0 - 4 .. x0 + 35 of the image,
// clamped to it, into sm.in; returns after a block barrier.
__device__ __forceinline__ void stage_tile(const float* __restrict__ im, Smem& sm,
                                           int y0, int x0, int H, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int off = kRing + kApron;
  const int gx_a = min(max(x0 - off + lane, 0), W - 1);
  const int gx_b = min(max(x0 - off + 32 + lane, 0), W - 1);
  for (int r = warp; r < kIn; r += kWarps) {
    const float* row = im + (size_t)min(max(y0 - off + r, 0), H - 1) * W;
    cp_async4(&sm.in[r][lane], row + gx_a);
    if (lane < kIn - 32) cp_async4(&sm.in[r][32 + lane], row + gx_b);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Best arc: max over the 16 arcs of 9 consecutive ring values of the arc's
// minimum, with the sign of every value flipped when flip is the sign bit
// (then it is minus the least arc maximum).
__device__ __forceinline__ float best_arc(const float (&ring)[16], unsigned flip) {
  float e[16], m2[16], m4[16], m8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = __uint_as_float(__float_as_uint(ring[k]) ^ flip);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(e[k], e[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m8[k] = fminf(m4[k], m4[(k + 4) & 15]);
  float a[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = fminf(m8[k], e[(k + 8) & 15]);
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = fmaxf(a[k], a[k + 8]);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = fmaxf(a[k], a[k + 4]);
  return fmaxf(fmaxf(a[0], a[2]), fmaxf(a[1], a[3]));
}

__device__ __forceinline__ float flip_sign(float x, unsigned flip) {
  return __uint_as_float(__float_as_uint(x) ^ flip);
}

// FAST score of the pixel at p (in sm.in), thresholded: side 1 bright, 2
// dark, 3 both (from the compass test). The arcs are taken over the raw ring
// values and the centre is subtracted once at the end: x -> fl(x - c) is
// monotone, so it commutes with min and max, and the result equals the
// reference's min/max over the rounded differences bit for bit. The dark
// side runs on the sign-flipped values (min -S = -max S exactly) and flips
// back, so that bright and dark lanes of a warp run one chain.
__device__ __forceinline__ float full_score(const float* p, int side, float t) {
  const float c = p[0];
  // Bresenham circle of radius 3, clockwise from the top (fast.CIRCLE).
  const float ring[16] = {
      p[-3 * kIn],     p[-3 * kIn + 1], p[-2 * kIn + 2], p[-kIn + 3],
      p[3],            p[kIn + 3],      p[2 * kIn + 2],  p[3 * kIn + 1],
      p[3 * kIn],      p[3 * kIn - 1],  p[2 * kIn - 2],  p[kIn - 3],
      p[-3],           p[-kIn - 3],     p[-2 * kIn - 2], p[-3 * kIn - 1]};
  const unsigned flip = side == 2 ? 0x80000000u : 0u;
  float s = flip_sign(flip_sign(best_arc(ring, flip), flip) - c, flip);
  if (side == 3) s = fmaxf(s, -(-best_arc(ring, 0x80000000u) - c));
  return s > t ? s : 0.0f;
}

// Score the tile plus its apron into sm.sc (0 outside the image, in the
// 3-pixel border and at or below the threshold). Pass 1: every pixel gets 0
// and the compass test; each warp lists its passing pixels (in order, by
// ballot and popc). After a block barrier, pass 2 scores the block's whole
// list 32 pixels per warp at a time (a corridor frame has ~40 per 34x34
// tile, so two warps take one round and the rest none). No barrier at the
// end.
__device__ __forceinline__ void score_tile(Smem& sm, int y0, int x0, int H, int W,
                                           float t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float nt = -t;
  const unsigned below = (1u << lane) - 1;
  int* list = sm.list[warp];
  int n = 0;
  // Test pixel (r, c) (ok: inside the image's interior) and list it if it
  // passes.
  auto test = [&](int r, int c, bool ok) {
    const float* p = &sm.in[r + kRing][c + kRing];
    const float n0 = p[-3 * kIn], e4 = p[3], s8 = p[3 * kIn], w12 = p[-3];
    // Best neighbouring compass pair, both above t (bright) or below -t
    // (dark), over raw values less the centre (exact, as in full_score).
    const float lo = fmaxf(fmaxf(fminf(n0, e4), fminf(e4, s8)),
                           fmaxf(fminf(s8, w12), fminf(w12, n0))) - p[0];
    const float hi = fminf(fminf(fmaxf(n0, e4), fmaxf(e4, s8)),
                           fminf(fmaxf(s8, w12), fmaxf(w12, n0))) - p[0];
    const int side = ok ? (lo > t) | ((hi < nt) << 1) : 0;
    const unsigned m = __ballot_sync(kFull, side != 0);
    if (side) list[n + __popc(m & below)] = (r * kSc + c) | (side << 16);
    n += __popc(m);
  };
  auto inner = [&](int g, int lo, int hi) { return g >= kRing + lo && g < hi - kRing; };
  // Lanes take columns 0-31 of rows warp, warp + 8, ... of the 34 scored
  // rows; warps 2-4 also take columns 32 and 33 of every row, two a row.
  static_assert(kSc == 4 * kWarps + 2 && 2 * kSc <= 3 * 32, "pass 1 covers 34x34");
  const bool col_ok = inner(x0 - kApron + lane, 0, W);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + kWarps * k;
    sm.sc[r][lane] = 0.0f;
    test(r, lane, col_ok && inner(y0 - kApron + r, 0, H));
  }
  if (warp < kSc - 4 * kWarps) {
    const int r = 4 * kWarps + warp;
    sm.sc[r][lane] = 0.0f;
    test(r, lane, col_ok && inner(y0 - kApron + r, 0, H));
  } else if (warp < kSc - 4 * kWarps + 3) {
    const int i = (warp - (kSc - 4 * kWarps)) * 32 + lane;  // 0 .. 95, 68 used
    const int r = min(i >> 1, kSc - 1), c = 32 + (i & 1);
    if (i < 2 * kSc) sm.sc[r][c] = 0.0f;
    test(r, c, i < 2 * kSc && inner(x0 - kApron + c, 0, W) && inner(y0 - kApron + r, 0, H));
  }
  if (lane == 0) sm.count[warp] = n;
  __syncthreads();
  int start[kWarps + 1];
  start[0] = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) start[w + 1] = start[w] + sm.count[w];
  for (int e = threadIdx.x; e < start[kWarps]; e += kThreads) {
    int w = 0, base = 0;  // the warp whose list holds entry e
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      if (e >= start[k]) {
        w = k;
        base = start[k];
      }
    }
    const int ent = sm.list[w][e - base];
    const int i = ent & 0xffff, r = i / kSc, c = i - r * kSc;
    sm.sc[r][c] = full_score(&sm.in[r + kRing][c + kRing], ent >> 16, t);
  }
}

// Float <-> int with the same order (for the warp's integer max reduction):
// negative floats get their magnitude bits flipped. -0 sorts just below +0;
// the holders of the maximum are then found by float equality, as ties.
__device__ __forceinline__ int to_key(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// One warp (w): the 8 candidates of the selection block whose top-left pixel
// is (ty, tx) in the tile and (gy0, gx0) in the image.
__device__ __forceinline__ void select_block(Smem& sm, int w, int ty, int tx, int gy0,
                                             int gx0, int H, int W, int Wp, int nms,
                                             float* __restrict__ val,
                                             int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  {
    // NMS: lane (h, c) takes column c of rows 8 h .. 8 h + 7 (10 x 3 reads,
    // bank-conflict free with the 34-float pitch), and stores the block in
    // lane order p = r * 16 + c, its second half padded by 16 floats so that
    // the stores are conflict free too.
    const int c = lane & 15, h = lane >> 4;
    float col[10][3];
#pragma unroll
    for (int q = 0; q < 10; ++q)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) col[q][dx] = sm.sc[ty + 8 * h + q][tx + c + dx];
    float row_max[10];
#pragma unroll
    for (int q = 0; q < 10; ++q) row_max[q] = fmaxf(fmaxf(col[q][0], col[q][1]), col[q][2]);
    const bool in_x = gx0 + c < W;
    float* out = sm.blk[w] + h * kHalfPad + c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // The 8 neighbours: the rows above and below, left and right.
      const float neigh = fmaxf(fmaxf(row_max[j], row_max[j + 2]),
                                fmaxf(col[j + 1][0], col[j + 1][2]));
      const float ctr = col[j + 1][1];
      const float v = nms ? (ctr >= neigh ? ctr : 0.0f) : ctr;
      out[16 * j] = (in_x && gy0 + 8 * h + j < H) ? v : 0.0f;
    }
  }
  __syncwarp();
  // Selection: lane l takes lanes p = 8 l .. 8 l + 7, so lane order is p
  // order and a lane's holders of the round's maximum take consecutive
  // slots after those of the lanes below it.
  const float* in = sm.blk[w] + (lane >> 4) * 16 + 8 * lane;
  const float4 lo = *reinterpret_cast<const float4*>(in);
  const float4 hi = *reinterpret_cast<const float4*>(in + 4);
  float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int gidx0 = (gy0 + (lane >> 1)) * Wp + gx0 + 8 * (lane & 1);
  const unsigned below = (1u << lane) - 1;
  int got = 0;
  // Each round takes every remaining holder of the largest remaining value,
  // so a finite block is done within 8 rounds.
  for (int round = 0; round < kCand && got < kCand; ++round) {
    const float lm = fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
                           fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
    const float m = from_key(__reduce_max_sync(kFull, to_key(lm)));
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) bits |= (v[j] == m ? 1u : 0u) << j;
    // Holders in the lanes below, and in the warp: bit-sliced ballots of
    // this lane's count (at most 8, four bits).
    const int cnt = __popc(bits);
    int before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned b = __ballot_sync(kFull, (cnt >> k) & 1);
      before += __popc(b & below) << k;
      total += __popc(b) << k;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int slot = got + before + __popc(bits & ((1u << j) - 1));
      const bool take = ((bits >> j) & 1u) && slot < kCand;
      if (take) {
        sm.out_val[w][slot] = v[j];
        sm.out_idx[w][slot] = gidx0 + j;
      }
      v[j] = take ? -INFINITY : v[j];
    }
    got += total;
  }
  __syncwarp();
  if (lane < kCand) {
    val[lane] = sm.out_val[w][lane];
    idx[lane] = sm.out_idx[w][lane];
  }
}

__global__ void __launch_bounds__(kThreads)
    fast_score_kernel(const float* __restrict__ img, float* __restrict__ out, int H,
                      int W, float threshold, int nms) {
  __shared__ Smem sm;
  const size_t b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  stage_tile(img + b * H * W, sm, y0, x0, H, W);
  score_tile(sm, y0, x0, H, W, threshold);
  __syncthreads();
  float* o = out + b * H * W;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const float ctr = sm.sc[r + 1][c + 1];
    float res = ctr;
    if (nms) {
      float neigh = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (dy != 1 || dx != 1) neigh = fmaxf(neigh, sm.sc[r + dy][c + dx]);
      res = ctr >= neigh ? ctr : 0.0f;
    }
    o[(size_t)gy * W + gx] = res;
  }
}

__global__ void __launch_bounds__(kThreads)
    fast_candidates_kernel(const float* __restrict__ img, float* __restrict__ cand_val,
                           int* __restrict__ cand_idx, int H, int W, float threshold,
                           int nms) {
  __shared__ Smem sm;
  const size_t b = blockIdx.z;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  stage_tile(img + b * H * W, sm, y0, x0, H, W);
  score_tile(sm, y0, x0, H, W, threshold);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp >= kPer * kPer) return;
  const int nby = (H + kBlk - 1) / kBlk, nbx = (W + kBlk - 1) / kBlk;
  const int by = blockIdx.y * kPer + warp / kPer, bx = blockIdx.x * kPer + warp % kPer;
  if (by >= nby || bx >= nbx) return;
  const size_t o = ((b * nby + by) * nbx + bx) * kCand;
  select_block(sm, warp, (warp / kPer) * kBlk, (warp % kPer) * kBlk, by * kBlk,
               bx * kBlk, H, W, nbx * kBlk, nms, cand_val + o, cand_idx + o);
}

}  // namespace

extern "C" int epivo_fast_score(const float* img, float* out, int B, int H,
                                int W, float threshold, int nms,
                                cudaStream_t stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  fast_score_kernel<<<grid, kThreads, 0, stream>>>(img, out, H, W, threshold, nms);
  return (int)cudaGetLastError();
}

extern "C" int epivo_fast_candidates(const float* img, float* cand_val, int* cand_idx,
                                     int B, int H, int W, float threshold, int nms,
                                     cudaStream_t stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  fast_candidates_kernel<<<grid, kThreads, 0, stream>>>(img, cand_val, cand_idx, H, W,
                                                        threshold, nms);
  return (int)cudaGetLastError();
}

extern "C" const char* epivo_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
