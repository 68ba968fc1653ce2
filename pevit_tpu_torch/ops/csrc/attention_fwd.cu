// Mask-free attention forward: out = softmax(q . k^T) . v per (batch, head).
//
// Replaces: pevit_tpu/ops/attention.py `_pallas_forward` (the Pallas kernel
// behind `_fused` / `attention_core`).  Same contract: q arrives already
// scaled by 1/sqrt(hd) with any PEFT delta added; logits, max, exp and sum in
// float32; the probabilities are normalised in float32 and rounded to the
// input type BEFORE the product with v (the reference rounds there, so an
// online softmax that normalises at the end would round differently in
// bf16); the product accumulates in float32 and the output is rounded once.
//
// What bounds it on an H100: the work is ~4*N*hd operations per query row
// against 4 * N * hd * elem bytes of q, k, v and out per head, i.e. ~N/elem
// bytes operations per byte: 25 at N = 50 in bf16, ~288 at N = 577, where
// it meets the ~295 at which the card turns compute-bound.  So at ViT-B
// shapes the bound is memory traffic (each of q, k, v, out read or written
// once), and at ViT-L/14 @ 336 px (N = 577) the two bounds meet.  In
// float32 the three TF32 products of each product (below) make the
// operations bound about as large as the bytes bound at N = 197.  The
// bodies stage rows of q, k and v in shared memory by 16-byte copies (the
// shared-memory body K and V by TMA boxes, q straight into registers), and
// take q, k and v with (batch, token, head) strides, so the wrapper passes
// (B, N, H, hd) views of the packed qkv projection without copies.  Every
// N >= 1 is taken: the dtype picks the body, and hd and N do (float32: the
// persistent body at hd <= 80, the mma.sync body beyond; bf16 at hd <= 64
// the persistent body up to N = 257; the body with the S tile in shared
// memory from 258 up to 640 tokens, where its tile fits beside a ring of
// four stages, and up to 768 with a ring of two; the three-walk long body
// otherwise), chosen by shape; no body falls back to another.
//
// Head widths.  The reference takes any hd (it pads hd to a multiple of 8
// for its lanes).  Here every body is built for a head width W, hd rounded
// up to the next of 64, 80, 96, 128 and 256 (all multiples of the mma
// k-step of 16), and the launcher passes hd: columns [hd, W) of q, k and v
// are staged as zeros, which leaves every logit as it is (a zero column of
// q meets a zero column of k) and only adds output columns that are never
// stored, so the result is the reference's at every hd.  hd must fill
// whole 16-byte chunks (a multiple of 8 in bf16, of 4 in float32); the
// wrapper zero-pads any other hd, as the reference does.  The bf16
// persistent and shared-memory bodies are built for W = 64 only, the
// float32 persistent body for W = 64 and 80; a wider head goes to the
// query-tiled bodies at every N.  Their output is cut into
// chunks of at most 128 columns, one block a chunk (two at hd > 128): a
// block recomputes S over
// the whole hd for its chunk of v's columns, which is exact, since p does
// not depend on v, and keeps a block's accumulators within its registers.
// A tile of rows a multiple of 64 elements wide keeps the XOR swizzle of
// 16-byte chunks by (row & 7); other widths (80, 96) pad each row by 16
// bytes, an odd number of 16-byte chunks, so that 8 consecutive rows'
// chunks of one column still meet 8 distinct bank groups (Tile below).
//
// bfloat16 persistent body, N <= 257, hd <= 64 (Hopper's TMA, wgmma,
// mbarriers and setmaxnreg), for the S rows that fit a warpgroup's wgmma
// accumulators: 64 query rows by up to 264 keys is 132 floats a thread.
// What bounds it: bytes at N = 50 (q, k, v and out once each: 0.0235 ms at
// batch 256 x 12 heads), each SM's issue slots above (a logit takes the
// row max, s - m, expf, the sum, the correctly rounded quotient's three
// instructions and half a pack; the tensor cores' products are the
// smaller part).  The design against the losses of the mma.sync body
// with S in registers that it replaced (a block of 4 warps a head that
// loads, waits, then computes; 2 blocks an SM; a division a logit):
//   * persistent: one block an SM walks the (batch, head) items, items
//     blockIdx.x + i gridDim.x, so a block's loads and products overlap
//     across items and its start-up is paid once;
//   * warp-specialised: warpgroup 0 gives up its registers (setmaxnreg 24)
//     and one of its threads issues each item's TMA boxes (its query tiles
//     of 64 rows, its K and V rows, tokens past N and columns past hd
//     zero-filled: a zero v row keeps p = 0 from meeting garbage) into a
//     ring of full / empty mbarriers, as many stages as 227 KB hold (two at
//     200 and 264 keys, eight at 56); two consumer warpgroups take the
//     rest (setmaxnreg 240) and the item's query tiles in turn (at N <= 64
//     each its own items), so one's softmax runs beside the other's
//     products and waits;
//   * S = Q K^T by wgmma with q and K from shared memory (products of at
//     most 128 keys, the descriptors formed where they are issued so that
//     none is held across the softmax), in the accumulators, which hold a
//     lane's keys as mma.sync's do: the row max, the sum in the replaced
//     body's order (a lane's columns, then the quad), e = expf(s - m) once,
//     p = e / l correctly rounded (1 / l once a row and the Markstein
//     residual a logit) and packed to bf16 as P V's A fragments: the
//     replaced body's numbers bit for bit;
//   * keys past N masked only in the 8-key groups at or past the next
//     smaller instantiation's key count (N exceeds it), instantiations at
//     56, 64, 128, 200 and 264 keys (N = 50, 197, 257 take 56, 200, 264);
//   * O = P V by wgmma (V as it lies, MN-major), rounded once, staged in
//     the tile's own q rows and stored in 16-byte chunks.
// Measured and not taken (PERF.md, section 6): the consumers taking turns at
// the tensor cores on named barriers (slower: one warpgroup's softmax
// alone leaves the issue slots idle), three consumers (they spill at 200
// and 264 keys and gain at most a few percent below).
//
// bfloat16 long body, hd > 64 or N > 768 (tensor cores: mma.sync m16n8k16
// on ldmatrix fragments of swizzled shared tiles, the output staged in the
// warp's own q rows).  The rounding
// point rules out a one-pass online softmax: p must be normalised by the
// row's final sum before it is rounded.  So the body holds one chunk's S
// (64 keys, 32 floats a lane) and walks the keys three times: the exact row
// max, then the float32 row sum l of exp(s - max) (which differs from the
// reference's only in its order: each lane sums its columns, then the
// quad's 4 lanes by shuffles), then p = exp(s - max) / l, rounded to bf16,
// and O += P V.  The recomputed Q K^T costs operations, not bytes, and
// the ceiling on N is gone:
//   * grid: one block per (batch, head, tile of 64 query rows, chunk of
//     output columns), 4 warps, a warp per 16 query rows, so a head's
//     queries spread over several SMs; a warp whose rows all lie past N
//     only takes part in the block's copies and barriers;
//   * keys and values in chunks of 64 rows by 16-byte cp.async into two
//     buffers (K alone in the first two passes), the copies of the next
//     chunk in flight during the products of this one; each pass starts on
//     the chunk the last one ended on and keeps its S;
//   * p's division is a product by the correctly rounded 1 / l and its
//     exact residual (Markstein), the correctly rounded quotient;
//   * 40 KB of shared memory at W = 64 (80 KB at 128, 128 KB at 256); it
//     computes Q K^T about 2.8 times a key and exp twice a logit, so it runs
//     only where neither body above does.
//
// bfloat16 body with the S tile in shared memory (Hopper's wgmma), the
// reference's own design brought to the card: `_pallas_forward` keeps a
// (b, h) S tile in VMEM, computes S once, the exact max, e = exp(s - m)
// once, p = e / sum(e) rounded, then P V.  Here a block of two warpgroups
// owns 64 query rows and keeps their float32 S tile (64 x N, rounded up to
// items of 128 keys) in shared memory: at most 640 keys beside the K / V
// ring and the row statistics in 227 KB (768 beside a shorter ring).  It
// is built for hd <= 64 (W = 64), where CLIP ViT-L/14 at 336 px and
// ViT-H/14 at 378 px run it, past the persistent body's 257 tokens: no configuration runs bf16 attention with wider heads (CLIP's
// heads are 64 wide, the auxiliary backbones run in float32), so those keep
// the three-walk body.  One Q K^T and one
// expf a logit, both products on wgmma, the numeric contract of the
// three-walk body (the exact row max, a float32 l, p normalised before it
// is rounded) with l's sum split between the warpgroups and O's between
// their keys.  What bounds it: not bytes (0.045 ms of q, k, v and out at
// (32, 577, 16, 64)) nor the tensor cores (0.044 ms), but each SM's issue
// slots and shared memory: one expf (eight instructions and a MUFU op) a
// logit, S written, read and written again as e, read once more (16 bytes
// a logit), and a block that fills an SM's shared memory, so nothing but
// its own two warpgroups hides a wait.  The design does what it can about
// that: each warpgroup streams its own half of every item through a ring
// of four stages by TMA, one thread issuing its boxes (issuing
// a cp.async a thread cost as much as the loads' latency), and waits on its
// own named barrier, so the two drift apart and one's arithmetic runs
// beside the other's products; walk 1 stores one item's S while the next
// item's product runs; walk 2 writes e over s (a second expf in walk 3
// instead was slower at every shape measured); the next items' copies are
// issued after the products they would wait behind; wgmma's register
// operands are written only outside a product's flight (else ptxas
// serializes every wgmma).
//
// From 641 to 768 tokens the same body keeps six items of S beside a ring
// of two stages, which prefetches one item instead of three.  Past 768 the
// tile of S no longer fits one block's 227 KB.
//
// float32 persistent body, hd <= 80 (3xTF32 on wgmma, TMA, warp-specialised:
// tf32x3.cuh's arithmetic, each k-step of 8 three TF32 products summed from
// zero on the tensor core and added to a float32 accumulator once, rounded,
// as the GEMM core's float32 path does it, wgmma_gemm.cuh).  What bounds it:
// at (64, 197, 12) the 3xTF32 products (30 GFLOP with the padding of
// queries to tiles of 64 and keys to chunks of 64) take 0.06 ms at the
// TF32 peak against 0.046 ms of q, k, v and out; below them, the issue
// slots and the latency of a consumer's chain of groups, and the splits.
// TF32 wgmma reads B K-major only, so K's rows serve S = Q K^T as they lie
// and V must become V^T for P V; and K and V are new every call, so their
// TF32 planes are made in the block.  The design:
//   * persistent: one block an SM walks jobs of two 64-query tiles of a
//     (batch, head) (at N <= 64, (batch, head)s, a consumer each), its
//     producer warpgroup ahead of its two consumer warpgroups;
//   * keys in chunks of 64: one thread streams each chunk's K and V rows
//     by TMA boxes into a raw ring, and the producer warpgroup's 128
//     threads split each raw chunk once into TF32 hi and lo planes, K's
//     where its values lie, V's transposed (V^T's rows, each 8-key step in
//     the order 0, 2, 4, 6, 1, 3, 5, 7); both consumers of a job read the
//     same planes, so a value is split once a pair of query tiles;
//   * a consumer holds its tile's q in registers and splits each k-step's
//     fragment as it issues it; S = Q K^T and O += P V run a k-step a group
//     of three wgmmas into a partial, each partial added once its group has
//     retired, another group in flight (every group added before the chunk
//     ends: ptxas serializes every wgmma otherwise); P's A fragments are
//     S's accumulators as they stand (V^T's key order above);
//   * the online softmax of the mma.sync body it replaced (the running row
//     max, exp(m_old - m_new) on the row sum and on O, e = exp(s - m), a
//     lane's pairs, the quad's sum at the end, O / l), with the rescale's
//     products rounded on their own;
//   * a last chunk whose keys below N fit 32 runs at half the width (N =
//     257: 257 keys in 4 full chunks and one of 32), and a job's second
//     tile past the (batch, head)'s last is not computed.
// Heads wider than 80 run the mma.sync body below, the earlier design: 3xTF32
// mma.sync m16n8k8 (tf32x3.cuh's mma_tf32x3), a block per (batch, head,
// 64-query tile, chunk of at most 128 output columns), 4 warps, keys in
// chunks of 32 through two cp.async buffers, each warp splitting the K and
// V values it reads, the same online softmax; q split once into registers
// up to W = 96 and kept in shared memory beyond.

// The launchers raise each kernel's dynamic shared memory limit with
// cudaFuncSetAttribute before its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"
#include "tma.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QROWS = WARPS * 16;  // query rows a block (the fp32 and the long bf16 body)
constexpr int REG_WIDTH = 64;      // the head width of the persistent and shared-memory bodies
constexpr int MAX_HD = 256;
constexpr int COL_CHUNK = 128;     // output columns a query-tiled block computes, at most

// ---------------------------------------------------------------------------
// the bf16 bodies' copy, fragment and quad helpers (bf16, smem_u32,
// cp_async16 and the wgmma descriptors come from wgmma_gemm.cuh, the
// mbarriers and the TMA maps from tma.cuh)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8, float32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A bf16 shared tile whose rows hold W elements (W a multiple of 16): rows
// a multiple of 64 wide XOR-swizzle their 16-byte chunks by (row & 7)
// within each 128-byte group; other rows are padded by one 16-byte chunk.
template <int W>
struct Tile {
  static constexpr bool XOR = W % 64 == 0;
  static constexpr int LD = XOR ? W : W + 8;  // row stride, elements
  static constexpr int CHUNKS = W / 8;        // 16-byte chunks a row
  // element offset of 16-byte chunk c of row r
  __device__ static __forceinline__ int at(int r, int c) {
    return XOR ? r * W + (((c & ~7) | ((c ^ r) & 7)) << 3) : r * LD + (c << 3);
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [r0, r0 + rows) and columns [col0, col0 + W) of one head into a
// (rows x W) tile; rows at or past N and columns at or past hd are zero (a
// zero v row keeps p = 0 from meeting garbage, which may be NaN; a zero k
// row keeps the logits finite before the mask; zero columns of q and k
// leave the logits as they are)
template <int W>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long sn, int r0,
                                           int rows, int N, int col0, int hd) {
  for (int e = threadIdx.x; e < rows * Tile<W>::CHUNKS; e += THREADS) {
    const int r = e / Tile<W>::CHUNKS, c = e - r * Tile<W>::CHUNKS;
    bf16* d = dst + Tile<W>::at(r, c);
    if (r0 + r < N && col0 + c * 8 < hd)
      cp_async16(smem_u32(d), src + (r0 + r) * sn + col0 + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body for N > 257 or hd > 64 (tensor cores, keys in chunks, three
// passes)
// ---------------------------------------------------------------------------

constexpr int KCHUNK = 64;         // keys per chunk
static_assert(QROWS == KCHUNK, "q, k and v tiles share one staging routine");

// The long body's shared memory at head width W and DV output columns a
// block: the q tile, then two buffers of a K tile and a V tile; and its
// blocks an SM for ptxas (W = 64 fits four in 128 registers; wider heads
// hold more fragments).
template <int W, int DV>
struct LongBody {
  static constexpr int QT = KCHUNK * Tile<W>::LD;   // elements of the q tile and a K tile
  static constexpr int VT = KCHUNK * Tile<DV>::LD;  // elements of a V tile
  static constexpr size_t SMEM = (size_t)(QT + 2 * (QT + VT)) * sizeof(bf16);
  static constexpr int MIN_BLOCKS = W == 64 ? 4 : W <= 96 ? 3 : 2;
};

// e / l rounded to nearest from rl, the correctly rounded 1 / l: a product
// and its exact residual (Markstein's correction) give the correctly
// rounded quotient wherever it is a normal float, as e / l would, in three
// instructions instead of a division's dozen
__device__ __forceinline__ float div_rn(float e, float l, float rl) {
  const float q = e * rl;
  return fmaf(fmaf(-q, l, e), rl, q);
}

// One block per (batch, head, tile of 64 query rows, chunk of DV output
// columns), a warp per 16 rows.  Three passes over the key chunks: 0 the
// row max m (exact: a max does not depend on order), 1 the row sum l of
// exp(s - m) in float32, 2 p = exp(s - m) / l rounded to bf16 and O += P V.
// Pass 1 walks the chunks backwards, so each pass starts on the chunk the
// last one ended on and takes its S from registers instead of recomputing
// it.  The chunks stream through two buffers by cp.async, the copies of
// iteration i + 1 in flight during the products of iteration i (K alone in
// passes 0 and 1, K and V in pass 2).  It takes any N; the launcher gives
// it N > 257, or any N at hd > 64.
template <int W, int DV>
__global__ void __launch_bounds__(THREADS, (LongBody<W, DV>::MIN_BLOCKS))
attention_fwd_bf16_long(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out, int H, int N,
                        int hd, int q_tiles, int col_chunks,
                        long long qsb, long long qsn, long long qsh,
                        long long ksb, long long ksn, long long ksh,
                        long long vsb, long long vsn, long long vsh) {
  typedef Tile<W> TQ;
  typedef Tile<DV> TV;
  typedef LongBody<W, DV> L;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  // buffer i: a K tile, then a V tile
  auto kv_s = [&](int i) { return q_s + L::QT + (i & 1) * (L::QT + L::VT); };

  const int dc = blockIdx.x % col_chunks, tile = blockIdx.x / col_chunks;
  const int bh = tile / q_tiles, qt = tile - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int r0 = qt * QROWS, d0 = dc * DV;
  const bf16* kh = k + b * ksb + h * ksh;
  const bf16* vh = v + b * vsb + h * vsh;
  const int C = (N + KCHUNK - 1) / KCHUNK;
  const int iters = 3 * C;
  // the chunk iteration it works on; whether it takes S from the one before
  auto chunk_of = [C](int it) {
    const int c = it % C;
    return it / C == 1 ? C - 1 - c : c;
  };
  auto reuses = [C](int it) { return it == C || it == 2 * C; };
  auto stage = [&](int it) {  // what iteration it reads, into buffer it & 1
    bf16* dst = kv_s(it);
    const int c = chunk_of(it);
    if (!reuses(it)) stage_tile<W>(dst, kh, ksn, c * KCHUNK, KCHUNK, N, 0, hd);
    if (it >= 2 * C) stage_tile<DV>(dst + L::QT, vh, vsn, c * KCHUNK, KCHUNK, N, d0, hd);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage_tile<W>(q_s, q + b * qsb + h * qsh, qsn, r0, QROWS, N, 0, hd);
  stage(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bool active = r0 + warp * 16 < N;  // uniform across the warp

  // Q fragments: W / 16 steps of 16 along hd
  uint32_t qa[W / 16][4];
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    ldmatrix_x4(qa[kk], smem_u32(q_s + TQ::at(warp * 16 + (lane & 15), 2 * kk + (lane >> 4))));

  // a lane holds rows g (s[j][0..1]) and g + 8 (s[j][2..3]) of the warp's
  // 16, columns 8j + 2t and 8j + 2t + 1 of the chunk; m and l per row, l
  // the lane's part until pass 1 ends, then rl = 1 / l
  float s[KCHUNK / 8][4], o[DV / 8][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, rl0 = 0.f, rl1 = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < iters; ++it) {
    if (it > 0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      // iteration it's tiles have landed, and every warp is done with the
      // buffer that iteration it - 1 read
      __syncthreads();
    }
    if (it + 1 < iters) stage(it + 1);
    if (!active) continue;
    const int pass = it / C, c = chunk_of(it);
    // 16-key tiles holding a key < N
    const int kt_n = min(KCHUNK / 16, (N - c * KCHUNK + 15) >> 4);
    const bf16* ks = kv_s(it);

    if (!reuses(it)) {
      // S = Q K^T over the chunk: n8 tile j covers keys 8j..8j+7
#pragma unroll
      for (int j = 0; j < KCHUNK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KCHUNK / 16; ++kt) {
        if (kt >= kt_n) continue;
        const int r = kt * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, smem_u32(ks + TQ::at(r, 2 * kk + ((lane >> 3) & 1))));
          mma_16816(s[2 * kt], qa[kk], kb[0], kb[1]);
          mma_16816(s[2 * kt + 1], qa[kk], kb[2], kb[3]);
        }
      }
      if ((c + 1) * KCHUNK > N) {  // the last chunk: key columns past N to -inf
#pragma unroll
        for (int j = 0; j < KCHUNK / 8; ++j) {
          const int col = c * KCHUNK + 8 * j + 2 * t;
          if (col >= N) s[j][0] = s[j][2] = -INFINITY;
          if (col + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
        }
      }
    }

    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < KCHUNK / 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      if (it == C - 1) {
        m0 = quad_max(m0);  // every row holds a key < N: finite
        m1 = quad_max(m1);
      }
    } else if (pass == 1) {
#pragma unroll
      for (int j = 0; j < KCHUNK / 8; ++j) {
        if (j >= 2 * kt_n) continue;  // every key past N: exp gives 0
        l0 += expf(s[j][0] - m0) + expf(s[j][1] - m0);
        l1 += expf(s[j][2] - m1) + expf(s[j][3] - m1);
      }
      if (it == 2 * C - 1) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        rl0 = __frcp_rn(l0);
        rl1 = __frcp_rn(l1);
      }
    } else {
      // O += P V, 16 keys at a time; p normalised in float32, then rounded
      // to bf16, which is exactly the A fragment of the product
      const bf16* vs = ks + L::QT;
#pragma unroll
      for (int kt = 0; kt < KCHUNK / 16; ++kt) {
        if (kt >= kt_n) continue;
        float p[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float* sj = s[2 * kt + h2];
          p[h2][0] = div_rn(expf(sj[0] - m0), l0, rl0);
          p[h2][1] = div_rn(expf(sj[1] - m0), l0, rl0);
          p[h2][2] = div_rn(expf(sj[2] - m1), l1, rl1);
          p[h2][3] = div_rn(expf(sj[3] - m1), l1, rl1);
        }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
        const int r = kt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dn = 0; dn < DV / 16; ++dn) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_u32(vs + TV::at(r, 2 * dn + (lane >> 4))));
          mma_16816(o[2 * dn], pa, vb[0], vb[1]);
          mma_16816(o[2 * dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  if (!active) return;

  // round once, stage in this warp's own q rows, 16-byte stores of the
  // chunk's columns below hd
  const int w0 = warp * 16 + (lane >> 2), w1 = w0 + 8;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    *reinterpret_cast<uint32_t*>(q_s + TQ::at(w0, j) + 2 * t) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(q_s + TQ::at(w1, j) + 2 * t) = pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  static_assert(16 * TV::CHUNKS % 32 == 0, "a warp's rows fill whole rounds of 32 lanes");
#pragma unroll
  for (int i = 0; i < 16 * TV::CHUNKS / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = warp * 16 + e / TV::CHUNKS, cc = e % TV::CHUNKS;
    const int col = d0 + cc * 8;
    if (r0 + r < N && col < hd)
      *reinterpret_cast<uint4*>(out + (((size_t)b * N + r0 + r) * H + h) * hd + col) =
          *reinterpret_cast<const uint4*>(q_s + TQ::at(r, cc));
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body with the S tile in shared memory (wgmma), hd <= 64:
// TMA_MAX_SEQ < N <= SMEM_MAX_SEQ with a ring of RING stages, up to
// SMEM2_MAX_SEQ with a ring of SHORT_RING
// ---------------------------------------------------------------------------

constexpr int RING = 4, SHORT_RING = 2;  // the ring's stages: deep, and where S leaves no room
// the longest N the body takes with each ring, five and six items of S
// (ops/attention.py mirrors them; the static_asserts below hold each
// layout to SMEM_BUDGET, tma.cuh's, there)
constexpr int SMEM_MAX_SEQ = 640;
constexpr int SMEM2_MAX_SEQ = 768;

// The body's layout at head width 64: the ring, 1024-byte aligned for the
// 128-byte swizzle, of `stages` stages, each an item of KI keys of K or V
// (128-byte rows in 64-row slabs of 8 KB); the float32 S tile of 64 query
// rows by N keys rounded up to whole items; each warpgroup's row max and
// row sum; the ring's mbarriers, a stage's for each warpgroup
struct SmemBody {
  static constexpr int W = REG_WIDTH;
  static constexpr int KI = 128;                 // keys of an item
  static constexpr int WGS = 2;                  // consumer warpgroups
  static constexpr int KW = KI / WGS;            // a warpgroup's keys of an item
  static constexpr int STAGE = KI * W * 2;       // bytes of a stage
  static constexpr int S_ITEM = QROWS * KI * 4;  // bytes of an item of S
  static constexpr int STATS = 2 * WGS * QROWS * 4;
  static constexpr int SLACK = 1024;
  static constexpr size_t bytes(int N, int stages) {
    return SLACK + stages * STAGE + (size_t)((N + KI - 1) / KI) * S_ITEM + STATS +
           8 * stages * WGS;
  }
};
static_assert(SmemBody::bytes(SMEM_MAX_SEQ, RING) <= SMEM_BUDGET,
              "the S tile fits at SMEM_MAX_SEQ");
static_assert(SmemBody::bytes(SMEM2_MAX_SEQ, SHORT_RING) <= SMEM_BUDGET,
              "the S tile fits at SMEM2_MAX_SEQ");

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B), "r"(scale_d));
}

// The ring's copies: TMA boxes of 64 columns (128 bytes) by a warpgroup's
// rows of an item, written in the 128-byte swizzle that wgmma_desc /
// wgmma_desc_mn name (a K item: Q K^T's B, K-major; a V item: P V's B,
// MN-major), rows at or past N and columns at or past hd zero-filled by the
// copy; each completes on its stage's mbarrier for the warpgroup.  One
// thread issues a warpgroup's boxes, so no thread spends issue slots on
// addresses or copies.
// A (64 columns x rows) box at (column, head, row, batch) of a (B, N, H, hd)
// tensor's map into shared memory at dst
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, uint32_t bar, int col,
                                        int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// Keeps the compiler from moving the definition of a wgmma's register
// operand past this point, into the wgmma's pipeline stage
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// The arguments of a launch of the shared-memory body but the K and V
// tensor maps
struct SmemArgs {
  const bf16* q;
  bf16* out;
  int H, N, hd, q_tiles;
  long long qsb, qsn, qsh;
};

// A warp's q fragments of a tile (W / 16 steps of 16 along hd, as
// mma.m16n8k16's A) straight from device memory, 4 bytes a load, while the
// first items stream in; rows at or past N and columns at or past hd zero
__device__ __forceinline__ void load_q(const SmemArgs& a, int tile,
                                       uint32_t (&qa)[SmemBody::W / 16][4]) {
  const int bh = tile / a.q_tiles, qt = tile - bh * a.q_tiles, b = bh / a.H, h = bh - b * a.H;
  const bf16* qh = a.q + b * a.qsb + h * a.qsh;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ra = qt * QROWS + (threadIdx.x % THREADS >> 5) * 16 + (lane >> 2), rb = ra + 8;
  auto at = [&](int r, int c) {
    return r < a.N && c < a.hd ? *reinterpret_cast<const uint32_t*>(qh + r * a.qsn + c) : 0u;
  };
#pragma unroll
  for (int kk = 0; kk < SmemBody::W / 16; ++kk) {
    const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;
    qa[kk][0] = at(ra, c0);
    qa[kk][1] = at(rb, c0);
    qa[kk][2] = at(ra, c1);
    qa[kk][3] = at(rb, c1);
  }
}

// item i of a tile (its K items 0..C-1, then its V items) of batch b and
// head h: this warpgroup's rows of it into its stage, by its thread 0, each
// warpgroup streaming its own keys
template <int ST>
__device__ __forceinline__ void load_item(const CUtensorMap& kmap, const CUtensorMap& vmap, int b,
                                          int h, int C, int i, uint32_t ring, uint32_t bars) {
  typedef SmemBody L;
  const int wg = threadIdx.x / THREADS;
  if (threadIdx.x % THREADS != 0) return;
  const uint32_t dst = ring + (i % ST) * L::STAGE + wg * L::KW * 128;
  const uint32_t bar = bars + (i % ST * 2 + wg) * 8;
  const int row = (i < C ? i : i - C) * L::KI + wg * L::KW;
  mbar_expect(bar, L::KW * 128);
  tma_box(dst, i < C ? kmap : vmap, bar, 0, h, row, b);
}

// One block per (batch, head, tile of 64 query rows) of two warpgroups:
// warpgroup w takes keys [w KW, (w + 1) KW) of every item of KI keys, so
// both work on every item the ring holds, and each SM scheduler has two
// warps to switch between.  The ring streams items in order: the K items
// 0..C-1, then the V items 0..C-1, each issued ST - 1 items ahead.
// Walk 1: S = Q K^T an item (wgmma m64n64k16, q in registers, read from
// device memory as the first items stream in), the keys past N at -inf,
// the running row max, S stored in float32; the two warpgroups' maxima meet
// in shared memory.  Walk 2, on chip only: e = exp(s - m) written over s,
// and each warpgroup's float32 row sum (items backwards, a lane's columns,
// the quad), the two added in shared memory (warpgroup 0's first), l's
// reciprocal rounded once.  Walk 3: p = e / l correctly rounded, rounded to
// bf16 into wgmma's A registers, O += P V over the warpgroup's keys;
// warpgroup 1's O is added to warpgroup 0's through shared memory.  A
// thread's S values are its own accumulators, so the tile is stored thread
// by thread (a float4 a lane, 512 contiguous bytes a warp) and read back by
// the same thread.  In walk 1 an item's product runs while the thread
// stores the item before it (two register buffers); walk 3 computes p only
// once the product before has been waited for, since a register operand
// written while a product is in flight makes ptxas serialize every wgmma.
template <int ST>
__global__ void __launch_bounds__(SmemBody::WGS * THREADS, 1)
attention_fwd_bf16_smem(const SmemArgs a, const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef SmemBody L;
  constexpr int W = L::W, KI = L::KI, KW = L::KW;
  const int H = a.H, N = a.N, hd = a.hd;
  const uint32_t ring = aligned_smem(smem);
  unsigned char* ring_p = smem + (ring - smem_u32(smem));
  const int C = (N + KI - 1) / KI;
  float4* s_tile = reinterpret_cast<float4*>(ring_p + ST * L::STAGE);
  float* stats = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s_tile) + C * L::S_ITEM);
  const uint32_t bars = smem_u32(stats) + L::STATS;  // [stage][warpgroup]

  const int tile = blockIdx.x;
  const int bh = tile / a.q_tiles, qt = tile - bh * a.q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int r0 = qt * QROWS;
  const int items = 2 * C;
  const int wg = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int row0 = warp * 16 + (lane >> 2), row1 = row0 + 8;  // a lane's rows of the tile
  // this warpgroup's float4 j of item c's S
  auto s_at = [&](int c, int j) -> float4& {
    return s_tile[(c * (KI / 8) + wg * (KW / 8) + j) * THREADS + tid];
  };
  const uint32_t wg_rows = wg * KW * 128;  // where this warpgroup's rows start in a stage

  // the top of item i: the warpgroup's rows have landed (its stage's
  // mbarrier, a phase a use), and its warps are done with the item before.
  // Each warpgroup waits only for its own warps (named barrier 1 + wg), so
  // the two drift apart and one's arithmetic runs beside the other's
  // products
  auto arrive = [&](int i) {
    mbar_wait(bars + (i % ST * 2 + wg) * 8, i / ST & 1);
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(THREADS) : "memory");
    return ring + (i % ST) * L::STAGE + wg_rows;
  };
  // once item i's products are issued: item i + ST - 1 into the stage of
  // the item before, its copies in flight while the tensor cores run
  auto refill = [&](int i) {
    if (i + ST - 1 < items) load_item<ST>(kmap, vmap, b, h, C, i + ST - 1, ring, bars);
  };

  // the barriers, the first items, and each warp's q fragments into
  // registers
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * ST; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < ST - 1 && i < items; ++i) load_item<ST>(kmap, vmap, b, h, C, i, ring, bars);
  uint32_t qa[W / 16][4];
  load_q(a, tile, qa);

  // walk 1.  A lane holds rows row0 (s[4j], s[4j + 1]) and row1 (s[4j + 2],
  // s[4j + 3]), keys wg KW + 8j + 2t and + 1 of the item
  float sa[KW / 2] = {}, sb[KW / 2] = {};
  float m0 = -INFINITY, m1 = -INFINITY;
  auto qk = [&](int c, float (&s)[KW / 2]) {  // wait for item c - 1's product, issue c's
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    const uint32_t st = arrive(c);
    uint64_t desc[W / 16];
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      desc[kk] = wgmma_desc(st + kk * 32);
      asm volatile("" : "+l"(desc[kk])::"memory");
    }
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) fence_operand(s[i]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) wgmma_m64n64k16_rs<0>(s, qa[kk], desc[kk], kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    refill(c);
  };
  // item c's S, its product waited for; only wgmma defines the accumulators
  // (an instruction that wrote them while another product is in flight would
  // make ptxas serialize every wgmma), so the mask goes into copies
  auto keep = [&](int c, float (&s)[KW / 2]) {
#pragma unroll
    for (int i = 0; i < KW / 2; ++i) fence_operand(s[i]);
    const int col0 = c * KI + wg * KW + 2 * t;  // the lane's first key
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      const bool in0 = col0 + 8 * j < N, in1 = col0 + 8 * j + 1 < N;  // keys past N: -inf
      const float4 x = make_float4(in0 ? s[4 * j] : -INFINITY, in1 ? s[4 * j + 1] : -INFINITY,
                                   in0 ? s[4 * j + 2] : -INFINITY,
                                   in1 ? s[4 * j + 3] : -INFINITY);
      m0 = fmaxf(m0, fmaxf(x.x, x.y));
      m1 = fmaxf(m1, fmaxf(x.z, x.w));
      s_at(c, j) = x;
    }
  };
  for (int c = 0; c < C; c += 2) {
    qk(c, sa);
    if (c > 0) keep(c - 1, sb);
    if (c + 1 < C) {
      qk(c + 1, sb);
      keep(c, sa);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  if (C & 1)
    keep(C - 1, sa);
  else
    keep(C - 1, sb);
  // the row max over both warpgroups' keys (exact: a max does not depend on
  // order; every row holds a key < N, so it is finite)
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  if (t == 0) {
    stats[wg * QROWS + row0] = m0;
    stats[wg * QROWS + row1] = m1;
  }
  __syncthreads();
  m0 = fmaxf(stats[row0], stats[QROWS + row0]);
  m1 = fmaxf(stats[row1], stats[QROWS + row1]);

  // walk 2.  Keys past N hold -inf and give e = 0, which leaves l as it is
  float l0 = 0.f, l1 = 0.f;
  for (int c = C - 1; c >= 0; --c) {
#pragma unroll
    for (int j = 0; j < KW / 8; ++j) {
      float4& x = s_at(c, j);
      const float4 e = make_float4(expf(x.x - m0), expf(x.y - m0), expf(x.z - m1),
                                   expf(x.w - m1));
      l0 += e.x + e.y;
      l1 += e.z + e.w;
      x = e;
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    stats[(2 + wg) * QROWS + row0] = l0;
    stats[(2 + wg) * QROWS + row1] = l1;
  }
  __syncthreads();
  l0 = stats[2 * QROWS + row0] + stats[3 * QROWS + row0];  // warpgroup 0's first
  l1 = stats[2 * QROWS + row1] + stats[3 * QROWS + row1];
  const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);

  // walk 3
  float o[W / 2];
  uint32_t pa[KW / 16][4];
  // p of the warpgroup's 16-key step kt: keys 16kt + 2t.. (rows row0, row1)
  // and 16kt + 8 + 2t.., which is exactly its A fragment
  auto probs = [&](int c) {
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) {
      const float4 x = s_at(c, 2 * kt), y = s_at(c, 2 * kt + 1);
      pa[kt][0] = pack_bf16(div_rn(x.x, l0, rl0), div_rn(x.y, l0, rl0));
      pa[kt][1] = pack_bf16(div_rn(x.z, l1, rl1), div_rn(x.w, l1, rl1));
      pa[kt][2] = pack_bf16(div_rn(y.x, l0, rl0), div_rn(y.y, l0, rl0));
      pa[kt][3] = pack_bf16(div_rn(y.z, l1, rl1), div_rn(y.w, l1, rl1));
    }
  };
  // issue item i's product from pa (keys past N give p = 0 against zero
  // rows of v: exact zeros)
  auto pv = [&](int i) {
    const uint32_t st = arrive(i);
    uint64_t desc[KW / 16];
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) {
      desc[kt] = wgmma_desc_mn(st + kt * 16 * 128);
      asm volatile("" : "+l"(desc[kt])::"memory");
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_reg(pa[kt][r]);
    }
#pragma unroll
    for (int j = 0; j < W / 2; ++j) fence_operand(o[j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kt = 0; kt < KW / 16; ++kt) wgmma_m64n64k16_rs<1>(o, pa[kt], desc[kt], 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    refill(i);
  };
#pragma unroll
  for (int j = 0; j < W / 2; ++j) o[j] = 0.f;
  for (int c = 0; c < C; ++c) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    probs(c);
    pv(C + c);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < W / 2; ++j) fence_operand(o[j]);

  // warpgroup 1's O into the S tile, which is done with (thread by
  // thread), added to warpgroup 0's; warpgroup 0 rounds once, stages its
  // rows in the same room, and stores the columns below hd in 16-byte
  // chunks
  float4* o_x = s_tile;
  __syncthreads();  // both warpgroups are done with the S tile
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      o_x[j * THREADS + tid] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float4 x = o_x[j * THREADS + tid];
      o[4 * j] += x.x;
      o[4 * j + 1] += x.y;
      o[4 * j + 2] += x.z;
      o[4 * j + 3] += x.w;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");  // warpgroup 0 read o_x
    typedef Tile<W> TO;
    bf16* o_s = reinterpret_cast<bf16*>(s_tile);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      *reinterpret_cast<uint32_t*>(o_s + TO::at(row0, j) + 2 * t) =
          pack_bf16(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(o_s + TO::at(row1, j) + 2 * t) =
          pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * TO::CHUNKS / 32; ++i) {
      const int e = lane + 32 * i;
      const int r = warp * 16 + e / TO::CHUNKS, cc = e % TO::CHUNKS;
      const int col = cc * 8;
      if (r0 + r < N && col < hd)
        *reinterpret_cast<uint4*>(a.out + (((size_t)b * N + r0 + r) * H + h) * hd + col) =
            *reinterpret_cast<const uint4*>(o_s + TO::at(r, cc));
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 persistent body (wgmma, TMA, warp-specialised), hd <= 64,
// N <= TMA_MAX_SEQ
// ---------------------------------------------------------------------------

// the longest N of the persistent body (ops/attention.py mirrors it)
constexpr int TMA_MAX_SEQ = 257;
// the key counts the body is built for (ops/attention.py mirrors them): N
// rounded up to the next
constexpr int TMA_KEYS[] = {56, 64, 128, 200, 264};
// consumer warpgroups a block (a third leaves too few registers for S at
// 200 keys and more), and setmaxnreg's counts: the producer's least, the
// consumers' the rest of an SM's 65,536 registers (a multiple of 8, at
// most 240)
constexpr int CONSUMERS = 2;
constexpr int TMA_THREADS = (1 + CONSUMERS) * THREADS;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_FIT = (65536 - PRODUCER_REGS * THREADS) / (CONSUMERS * THREADS) / 8 * 8;
constexpr int CONSUMER_REGS = CONSUMER_FIT < 240 ? CONSUMER_FIT : 240;

// wgmma m64nNk16, A and B K-major in shared memory (the 128-byte swizzle),
// float32 accumulators d (N / 2 a thread); ACC: add to d, else d = A B
template <int N, bool ACC>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<8, false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<8, true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16, false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<16, true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32, false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<32, true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]),
        "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]),
        "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


// S = Q K^T of a query tile over keys [OFF, NK), NK a multiple of 8: one
// wgmma of at most 128 keys after another into s's columns, q's descriptor
// da, dk the descriptor of K's row 0.  A descriptor's low bits hold its
// address / 16, so an offset into the tile is added to it (the callers
// form da and dk where the products are issued, so that no descriptor is
// held in registers across the softmax)
template <int NK, bool ACC, int OFF = 0>
__device__ __forceinline__ void qk_product(float (&s)[NK / 2], uint64_t da, uint64_t dk) {
  if constexpr (OFF < NK) {
    constexpr int R = NK - OFF;
    constexpr int C = R >= 128 ? 128 : R >= 64 ? 64 : R >= 32 ? 32 : R >= 16 ? 16 : 8;
    wgmma_ss<C, ACC>(s + OFF / 2, da, dk + OFF * 128 / 16);
    qk_product<NK, ACC, OFF + C>(s, da, dk);
  }
}

// The persistent body's layout for S rows of NK keys (N <= NK, a multiple
// of 8): a stage holds an item's (a (batch, head)'s) query tiles, then its
// K rows and its V rows padded to P V's k-steps of 16 (NKP), 128 bytes a
// row in the 128-byte swizzle; as many stages as 227 KB hold, at most 8;
// then a full and an empty mbarrier a stage
// the largest key count the body is built for below nk (0 for the first)
constexpr int keys_below(int nk) {
  int below = 0;
  for (int k : TMA_KEYS) below = k < nk ? k : below;
  return below;
}

template <int NK>
struct TmaBody {
  static constexpr int W = REG_WIDTH;
  // N > keys_below(NK): the keys below it are all below N, unmasked
  static constexpr int MASK_FROM = keys_below(NK) / 8 * 8;
  static constexpr int QT = (NK + QROWS - 1) / QROWS;       // query tiles an item, at most
  static constexpr int NKP = (NK + 15) / 16 * 16;           // K and V rows a stage
  static constexpr int KV_BOX = NKP <= 256 ? NKP : NKP / 2;  // a TMA box's rows: at most 256
  static constexpr int Q_BYTES = QT * QROWS * 128;
  static constexpr int KV_BYTES = NKP * 128;
  static constexpr int STAGE = Q_BYTES + 2 * KV_BYTES;
  static constexpr int SLACK = 1024;                         // the ring's 1024-byte alignment
  static constexpr int FIT = (SMEM_BUDGET - SLACK) / (STAGE + 16);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM = SLACK + (size_t)STAGES * (STAGE + 16);
  static_assert(NK % 8 == 0 && NK <= 272 && NKP % KV_BOX == 0 && KV_BOX % 8 == 0, "NK");
  static_assert(STAGES >= 2 && SMEM <= SMEM_BUDGET, "two stages fit");
};

// The arguments of a launch of the persistent body but its tensor maps
struct TmaArgs {
  bf16* out;
  int H, N, hd, items;  // items: B * H
};

// One block an SM walks items blockIdx.x, blockIdx.x + gridDim.x, ... (an
// item a (batch, head): item = b H + h) in order, and its warpgroups walk
// them together.  Warpgroup 0 is the producer: it gives up its registers
// (setmaxnreg) and one thread issues each item's TMA boxes (its query
// tiles, its K and V rows; tokens past N and columns past hd come in as
// zeros) into the ring, ahead of the consumers wherever a stage is free.
// The CONSUMERS warpgroups after it take the query tiles of the walk in
// turn, tile k of the block's walk to consumer k % CONSUMERS (at N <= 64 an
// item holds one tile, so each takes its own items; above, they split an
// item's tiles; tests/test_torch_attention_tma.py mirrors the walk).  For
// a tile a consumer computes
//   S = Q K^T (wgmma, q and K from shared memory; the 64 x NK float32 tile
//     in its accumulators, NK / 2 a thread), the keys past N at -inf;
//   the exact row max and the float32 row sum of e = exp(s - m) by quad
//     shuffles (a lane holds rows g and g + 8 of its warp's 16, keys 8j +
//     2t and + 1 as mma.sync's accumulators hold them, so the sum runs in
//     the order of the mma.sync body it replaced);
//   p = e / l correctly rounded (1 / l rounded once a row, then a product
//     and its Markstein residual a logit), rounded to bf16 straight into
//     wgmma's A fragments;
//   O = P V (wgmma, P from registers, V from shared memory as it lies:
//     MN-major), rounded once, staged in the tile's own q rows and stored
//     in 16-byte chunks, rows past N and columns past hd left out.
// A consumer waits for every item (its full mbarrier) and, done with its
// tiles, releases the stage (the empty mbarrier, a warp's arrival each).
// The consumers run free of each other: turns at the tensor cores on named
// barriers, one's softmax beside the other's products, were slower
// (PERF.md, section 6).
template <int NK>
__global__ void __launch_bounds__(TMA_THREADS, 1)
attention_fwd_bf16_tma(const TmaArgs a, const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap) {
  typedef TmaBody<NK> L;
  constexpr int ST = L::STAGES, KT = L::NKP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = aligned_smem(smem);
  unsigned char* ring_p = smem + (ring - smem_u32(smem));
  const uint32_t full = ring + ST * L::STAGE, empty = full + 8 * ST;
  const int N = a.N, H = a.H;
  const int q_tiles = (N + QROWS - 1) / QROWS;
  const int wg = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s);
      mbar_init(empty + 8 * s, CONSUMERS * WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != 0) return;
    const uint32_t bytes = q_tiles * QROWS * 128 + 2 * L::KV_BYTES;
    int it = 0;
    for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++it) {
      const int s = it % ST, use = it / ST;
      if (use > 0) mbar_wait(empty + 8 * s, (use - 1) & 1);  // the consumers are done with it
      const int b = item / H, h = item - b * H;
      const uint32_t st = ring + s * L::STAGE, bar = full + 8 * s;
      mbar_expect(bar, bytes);
      for (int t = 0; t < q_tiles; ++t) tma_box(st + t * QROWS * 128, qmap, bar, 0, h, t * QROWS, b);
#pragma unroll
      for (int r = 0; r < L::NKP; r += L::KV_BOX) {
        tma_box(st + L::Q_BYTES + r * 128, kmap, bar, 0, h, r, b);
        tma_box(st + L::Q_BYTES + L::KV_BYTES + r * 128, vmap, bar, 0, h, r, b);
      }
    }
    return;
  }

  // a consumer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int row0 = warp * 16 + (lane >> 2), row1 = row0 + 8;  // a lane's rows of a tile
  int k = 0, it = 0;
  for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++it) {
    const int s = it % ST;
    mbar_wait(full + 8 * s, (it / ST) & 1);
    const int b = item / H, h = item - b * H;
    const uint32_t st = ring + s * L::STAGE;
    const uint32_t ks = st + L::Q_BYTES, vs = ks + L::KV_BYTES;
    for (int qt = 0; qt < q_tiles; ++qt, ++k) {
      if (k % CONSUMERS != c) continue;
      const uint32_t qs = st + qt * QROWS * 128;

      // S = Q K^T
      float sc[NK / 2];
      uint64_t dq = wgmma_desc(qs), dk = wgmma_desc(ks);
      asm volatile("" : "+l"(dq), "+l"(dk));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      qk_product<NK, false>(sc, dq, dk);
#pragma unroll
      for (int kk = 1; kk < L::W / 16; ++kk)  // 32 bytes a k-step of 16
        qk_product<NK, true>(sc, dq + kk * 2, dk + kk * 2);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) fence_operand(sc[i]);

      // the softmax: keys past N at -inf (only keys from MASK_FROM on may
      // be), the exact row max, e = exp(s - m) once, the float32 row sum
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        if (8 * j >= L::MASK_FROM) {
          const int col = 8 * j + 2 * t;
          if (col >= N) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
          if (col + 1 >= N) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        m1 = fmaxf(m1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      m0 = quad_max(m0);  // every row holds a key < N: finite
      m1 = quad_max(m1);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        sc[4 * j] = expf(sc[4 * j] - m0);
        sc[4 * j + 1] = expf(sc[4 * j + 1] - m0);
        sc[4 * j + 2] = expf(sc[4 * j + 2] - m1);
        sc[4 * j + 3] = expf(sc[4 * j + 3] - m1);
        l0 += sc[4 * j] + sc[4 * j + 1];
        l1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);
      // p of 16-key step kt: keys 16kt + 2t.. and 16kt + 8 + 2t.. of rows
      // row0 and row1, exactly its A fragment; keys past NK give p = 0
      uint32_t pa[KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int j = 2 * kt + h2;
          if (j < NK / 8) {
            pa[kt][2 * h2] = pack_bf16(div_rn(sc[4 * j], l0, rl0), div_rn(sc[4 * j + 1], l0, rl0));
            pa[kt][2 * h2 + 1] =
                pack_bf16(div_rn(sc[4 * j + 2], l1, rl1), div_rn(sc[4 * j + 3], l1, rl1));
          } else {
            pa[kt][2 * h2] = pa[kt][2 * h2 + 1] = 0u;
          }
        }
      }

      // O = P V (keys past N: p = 0 against zero rows of v, exact zeros)
      float o[L::W / 2];
#pragma unroll
      for (int j = 0; j < L::W / 2; ++j) o[j] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_reg(pa[kt][r]);
#pragma unroll
      for (int j = 0; j < L::W / 2; ++j) fence_operand(o[j]);
      uint64_t dv = wgmma_desc_mn(vs);
      asm volatile("" : "+l"(dv));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)  // 16 rows of 128 bytes a k-step
        wgmma_m64n64k16_rs<1>(o, pa[kt], dv + kt * 16 * 128 / 16, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < L::W / 2; ++j) fence_operand(o[j]);

      // round once, stage in the tile's own q rows (this warp's 16), store
      // the rows below N and the columns below hd in 16-byte chunks
      typedef Tile<L::W> TO;
      bf16* o_s = reinterpret_cast<bf16*>(ring_p + (qs - ring));
#pragma unroll
      for (int j = 0; j < L::W / 8; ++j) {
        *reinterpret_cast<uint32_t*>(o_s + TO::at(row0, j) + 2 * t) = pack_bf16(o[4 * j], o[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(o_s + TO::at(row1, j) + 2 * t) =
            pack_bf16(o[4 * j + 2], o[4 * j + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16 * TO::CHUNKS / 32; ++i) {
        const int e = lane + 32 * i;
        const int r = warp * 16 + e / TO::CHUNKS, cc = e % TO::CHUNKS;
        const int row = qt * QROWS + r;
        if (row < N && cc * 8 < a.hd)
          *reinterpret_cast<uint4*>(a.out + (((size_t)b * N + row) * H + h) * a.hd + cc * 8) =
              *reinterpret_cast<const uint4*>(o_s + TO::at(r, cc));
      }
    }
    // the stage back to the producer: this warp's staging stores ordered
    // before the next item's TMA writes there
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
}

// ---------------------------------------------------------------------------
// float32 persistent body (3xTF32 wgmma, TMA, warp-specialised), hd <= 80
// ---------------------------------------------------------------------------

// keys of a chunk (a multiple of 64: V^T's planes hold a 128-byte row of 32
// TF32 keys a column block, and a narrow last chunk half of them)
constexpr int F32_CHUNK = 64;
// the widest head the body takes (ops/attention.py mirrors it); wider heads
// run the mma.sync body below
constexpr int F32_TMA_WIDTH = 80;
// the stages of each plane ring (K's, V^T's), an even count: unpaired, a
// consumer owns the stages of its parity
constexpr int F32_PLANE_STAGES = 2;
// the partial sums a consumer rotates in S = Q K^T and in O += P V (groups
// in flight while one is added; three spill)
constexpr int F32_S_PARTIALS = 2;
constexpr int F32_PV_PARTIALS = 2;
// the producer warpgroup's threads split the chunks, its thread 0 also
// issues the TMA boxes
constexpr int F32_SPLITTERS = THREADS;
// setmaxnreg's counts: the producer warpgroup's (its splitters' loops
// included), the consumers' the rest of an SM's registers
constexpr int F32_PRODUCER_REGS = 40;
constexpr int F32_CONSUMER_REGS = 232;
static_assert(THREADS * (F32_PRODUCER_REGS + CONSUMERS * F32_CONSUMER_REGS) <= 65536,
              "the warpgroups' registers fit an SM");

// The body's layout at head width W (64 or 80): a raw ring, each stage a
// chunk's K rows then its V rows as TMA writes them (column blocks of 32
// floats, a 128-byte row of a block a key, in the 128-byte swizzle); a K
// ring, each stage K's TF32 hi and lo planes laid out as the raw K rows
// (S's B, K-major); a V ring, each stage V^T's hi and lo planes (column
// blocks of 32 keys, a 128-byte row of a block a column of V: P V's B,
// K-major); then a full and an empty mbarrier a stage of each.  As many raw
// stages as 227 KB hold beside the planes, at most four.
template <int W>
struct F32TmaBody {
  static constexpr int KC = F32_CHUNK;
  static constexpr int CB = (W + 31) / 32;  // column blocks of a K or V row
  static constexpr int BLOCK = KC * 128;    // a column block of a chunk's rows
  static constexpr int RAW = 2 * CB * BLOCK;
  static constexpr int K_PLANE = CB * BLOCK;
  static constexpr int VT_BLOCK = W * 128;  // 32 keys of every column of V
  static constexpr int VT_PLANE = KC / 32 * VT_BLOCK;
  static constexpr int PS = F32_PLANE_STAGES;
  static constexpr int SP = F32_S_PARTIALS;
  static constexpr int VP = F32_PV_PARTIALS;
  static constexpr int SLACK = 1024;  // the raw ring's 1024-byte alignment
  static constexpr int PLANES = PS * (2 * K_PLANE + 16 + 2 * VT_PLANE + 16);
  static constexpr int FIT = (SMEM_BUDGET - SLACK - PLANES) / (RAW + 16);
  static constexpr int RS = FIT < 4 ? FIT : 4;
  static constexpr size_t SMEM = SLACK + (size_t)RS * (RAW + 16) + PLANES;
  static_assert(W % 16 == 0 && W <= F32_TMA_WIDTH && KC % 64 == 0, "widths wgmma takes");
  static_assert(RS >= 1 && PS % 2 == 0 && SMEM <= SMEM_BUDGET, "the stages fit");
  static_assert(K_PLANE % 1024 == 0 && VT_BLOCK % 1024 == 0, "tiles on the swizzle's 1024 bytes");
};

// The arguments of a launch of the float32 body but its tensor maps
struct F32Args {
  const float* q;
  float* out;
  int H, N, hd, q_tiles, work;  // work: the jobs (q_tiles > 1) or the (batch, head)s
  long long qsb, qsn, qsh;
};

// One k-step of 8 of a float32 product on the tensor cores: the three TF32
// products of the split (tf32x3.cuh), summed from zero into part, the small
// terms first; A (hi, lo) a warp's fragment in registers, B's hi and lo
// planes K-major in shared memory
template <int NW>
__device__ __forceinline__ void tf32x3_step(float (&part)[NW / 2], const uint32_t (&hi)[4],
                                            const uint32_t (&lo)[4], uint64_t b_hi,
                                            uint64_t b_lo) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  WgmmaTf32<NW>::mma(part, lo, b_hi, 0);  // from zero, the small terms first
  WgmmaTf32<NW>::mma(part, hi, b_lo, 1);
  WgmmaTf32<NW>::mma(part, hi, b_hi, 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// G groups, issued one after another (issue(q): group q's products into
// partial q % P), each added once it has retired (add(q)), so that P - 1
// groups run while one is added; every group added before it returns (a
// group read after a loop's back edge would make ptxas serialize every
// wgmma)
template <int G, int P, typename Issue, typename Add>
__device__ __forceinline__ void run_groups(Issue&& issue, Add&& add) {
  static_assert(G >= P - 1, "the partials fill");
  unroll<G>([&](auto qc) {
    constexpr int q = decltype(qc)::value;
    issue(qc);
    if constexpr (q >= P - 1) {
      asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(P - 1) : "memory");
      add(std::integral_constant<int, q - (P - 1)>{});
    }
  });
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  unroll<P - 1>(
      [&](auto i) { add(std::integral_constant<int, G - (P - 1) + decltype(i)::value>{}); });
}

// A fragment's four float32 values split: hi with its 13 low bits clear,
// lo with split_tf32's (the tensor core reads the top 19)
__device__ __forceinline__ void split_fragment(const float (&x)[4], uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    split_tf32(x[r], hi[r], lo[r]);
    hi[r] &= 0xffffe000u;
  }
}

// A chunk's first `rows` raw K rows split into K's TF32 planes by splitter
// thread t of F32_SPLITTERS, each value's hi and lo where the value lies;
// columns past W are left out (K's last block at W = 80)
template <int W>
__device__ __forceinline__ void split_k(const unsigned char* raw, unsigned char* k_hi, int t,
                                        int rows) {
  typedef F32TmaBody<W> L;
  constexpr int Q = W / 4;  // 16-byte chunks of a row below W
  const int TOTAL = rows * Q;
  constexpr int BATCH = 2;                     // chunks a thread loads before it stores
  for (int i0 = t; i0 < TOTAL; i0 += BATCH * F32_SPLITTERS) {
    int at[BATCH];
    float4 x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * F32_SPLITTERS, r = i / Q, c = i - r * Q;
      at[u] = c / 8 * L::BLOCK + r * 128 + (((c % 8) ^ (r % 8)) << 4);
      if (i < TOTAL) x[u] = *reinterpret_cast<const float4*>(raw + at[u]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (i0 + u * F32_SPLITTERS >= TOTAL) break;
      uint32_t hi[4], lo[4];
      split_tf32_rn(x[u].x, hi[0], lo[0]);
      split_tf32_rn(x[u].y, hi[1], lo[1]);
      split_tf32_rn(x[u].z, hi[2], lo[2]);
      split_tf32_rn(x[u].w, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(k_hi + at[u]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(k_hi + L::K_PLANE + at[u]) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// A chunk's first `rows` raw V rows split into V^T's TF32 planes by
// splitter thread t: each value into the row of its column, each 8-key
// step's keys in the order 0, 2, 4, 6, 1, 3, 5, 7, so that a consumer lane's
// S accumulators (keys 2t and 2t + 1 of the step) are P V's A fragment as
// they stand (k-indices t and t + 4); the sum over the keys does not depend
// on their order
template <int W>
__device__ __forceinline__ void split_v(const unsigned char* raw, unsigned char* v_hi, int t,
                                        int rows) {
  typedef F32TmaBody<W> L;
  for (int i = t; i < W * (rows / 8); i += F32_SPLITTERS) {
    const int d = i % W, s = i / W;  // V's column, the chunk's k-step
    const unsigned char* col = raw + d / 32 * L::BLOCK + d % 4 * 4;
    const int dc = d % 32 / 4;
    unsigned char* row = v_hi + s / 4 * L::VT_BLOCK + d * 128;
    float x[8];  // the step's keys at their slots, loaded before any store
#pragma unroll
    for (int odd = 0; odd < 2; ++odd)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = 8 * s + 2 * u + odd;  // key % 8 = 2u + odd
        x[4 * odd + u] = *reinterpret_cast<const float*>(col + key * 128 +
                                                         ((dc ^ (2 * u + odd)) << 4));
      }
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {  // keys 8s + 2u + odd at slots 4 odd + u
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) split_tf32_rn(x[4 * odd + u], hi[u], lo[u]);
      const int at = ((s % 4 * 2 + odd) ^ (d % 8)) << 4;
      *reinterpret_cast<uint4*>(row + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(row + L::VT_PLANE + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// One block an SM of three warpgroups walks jobs blockIdx.x + j gridDim.x:
// where a (batch, head) has more than one query tile, a job is two of its
// tiles (job w: item w / JT, tiles 2 (w % JT) and + 1), both consumers take
// each of its chunks (the job's j-th chunk ch is entry j C + ch of the
// block's rings), consumer c its tile 2 (w % JT) + c; at N <= 64 a unit is
// a (batch, head), unit i of the walk goes to consumer i % 2, and its chunk
// ch is entry 2 (C (i / 2) + ch) + i % 2, so each consumer owns the plane
// stages of its parity (tests/test_torch_attention_f32_tma.py mirrors the
// walk).  Keys come in chunks of F32_CHUNK.
//   * The producer warpgroup gives up its registers (setmaxnreg).  Its
//     thread 0 issues each entry's TMA boxes (K's and V's rows of the
//     chunk, rows past N zero) into the raw ring up to RS entries ahead,
//     each into a stage once every splitter is done with it; all 128 of
//     its threads split each raw chunk once, K into the K ring once its
//     consumers' S no longer reads the stage, V into the V ring once their
//     P V no longer does, a warp's arrival on each mbarrier, then free the
//     raw stage.
//   * A consumer (setmaxnreg 232) holds its tile's q fragments (float32,
//     from device memory) in registers and, for each chunk:
//     S = Q K^T, each k-step of 8 along hd three wgmma m64n64k8.tf32 (n32
//     in a narrow last chunk) from zero into a partial (tf32x3_step),
//     added to S once its group has retired (run_groups); frees the K
//     stage;
//     the online softmax (keys past N at -inf, the running row max m,
//     exp(m_old - m_new) on the row sum l and on O, rounded products,
//     e = exp(s - m), l += e a pair of keys at a time);
//     O += P V, each 8-key step three wgmma m64nWk8.tf32 with P's split
//     as A from the S accumulators and V^T's planes as B, added the same
//     way; frees the V stage.
//     The output O / l is stored from the accumulators, rows past N and
//     columns past hd left out.
template <int W>
__global__ void __launch_bounds__(TMA_THREADS, 1)
attention_fwd_f32_tma(const F32Args a, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap) {
  typedef F32TmaBody<W> L;
  constexpr int RS = L::RS, PS = L::PS, KC = L::KC;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = aligned_smem(smem);
  unsigned char* raw_p = smem + (raw - smem_u32(smem));
  const uint32_t k_ring = raw + RS * L::RAW, v_ring = k_ring + PS * 2 * L::K_PLANE;
  unsigned char* k_ring_p = raw_p + RS * L::RAW;
  unsigned char* v_ring_p = k_ring_p + PS * 2 * L::K_PLANE;
  const uint32_t raw_full = v_ring + PS * 2 * L::VT_PLANE, raw_empty = raw_full + 8 * RS;
  const uint32_t k_full = raw_empty + 8 * RS, k_empty = k_full + 8 * PS;
  const uint32_t v_full = k_empty + 8 * PS, v_empty = v_full + 8 * PS;
  const int N = a.N, C = (N + KC - 1) / KC;
  const int wg = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  // paired: a job is two query tiles of one (batch, head) whose chunks both
  // consumers take (JT jobs an item); else (N <= 64) each consumer takes
  // its own units, a (batch, head) of one query tile.  The block's jobs or
  // units, and its rings' entries (unpaired, the last pair's second unit
  // may be missing: its entries are skipped)
  const bool paired = a.q_tiles > 1;
  const int JT = (a.q_tiles + 1) / 2;
  const int mine = (a.work - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int entries = paired ? C * mine : 2 * C * ((mine + 1) / 2);
  // entry e's item and chunk; whether it is present
  const auto entry_at = [&](int e, int& item, int& ch) {
    if (paired) {
      item = ((int)blockIdx.x + e / C * (int)gridDim.x) / JT;
      ch = e % C;
      return true;
    }
    const int i = e / (2 * C) * 2 + e % 2;  // the entry's unit
    item = (int)blockIdx.x + i * (int)gridDim.x;
    ch = e / 2 % C;
    return i < mine;
  };
  // whether chunk ch is the last and its keys below N fit KC / 2: its
  // products then run at half the width, its split on half the rows
  const auto narrow_last = [&](int ch) { return ch == C - 1 && N - ch * KC <= KC / 2; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < RS; ++s) {
      mbar_init(raw_full + 8 * s);
      mbar_init(raw_empty + 8 * s, WARPS);  // a splitter warp's arrival each
    }
    for (int s = 0; s < PS; ++s) {
      mbar_init(k_full + 8 * s, WARPS);
      mbar_init(k_empty + 8 * s, paired ? 2 * WARPS : WARPS);  // its consumers' warps
      mbar_init(v_full + 8 * s, WARPS);
      mbar_init(v_empty + 8 * s, paired ? 2 * WARPS : WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F32_PRODUCER_REGS));
    // thread 0 issues the present entries' TMA boxes into the raw ring (its
    // count `issued`, from entry `next`), up to RS ahead of the splitting
    int next = 0, issued = 0;
    const auto issue_upto = [&](int until) {
      for (; next < entries && issued < until; ++next) {
        int item, ch;
        if (!entry_at(next, item, ch)) continue;
        const int s = issued % RS, use = issued / RS;
        ++issued;
        if (use > 0) mbar_wait(raw_empty + 8 * s, (use - 1) & 1);  // the splitters are done
        const int b = item / a.H, h = item - b * a.H, row = ch * KC;
        const uint32_t st = raw + s * L::RAW, bar = raw_full + 8 * s;
        mbar_expect(bar, L::RAW);
#pragma unroll
        for (int cb = 0; cb < L::CB; ++cb) {
          tma_box(st + cb * L::BLOCK, kmap, bar, 32 * cb, h, row, b);
          tma_box(st + (L::CB + cb) * L::BLOCK, vmap, bar, 32 * cb, h, row, b);
        }
      }
    };
    if (tid == 0) issue_upto(RS);
    const int lane = tid & 31;
    // every thread splits each present entry (its count n)
    for (int e = 0, n = 0; e < entries; ++e) {
      int item, ch;
      if (!entry_at(e, item, ch)) continue;
      const int s = n % RS, rpar = n / RS & 1, ps = e % PS, ppar = e / PS & 1;
      ++n;
      const unsigned char* st = raw_p + s * L::RAW;
      mbar_wait(raw_full + 8 * s, rpar);
      if (e >= PS) mbar_wait(k_empty + 8 * ps, ppar ^ 1);  // its consumers' S is done with it
      const int rows = narrow_last(ch) ? KC / 2 : KC;
      split_k<W>(st, k_ring_p + ps * 2 * L::K_PLANE, tid, rows);
      // the planes' stores before the consumers' wgmmas read them, a warp's
      // arrival once its lanes are done (one arrival a thread serializes)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(k_full + 8 * ps);
      if (e >= PS) mbar_wait(v_empty + 8 * ps, ppar ^ 1);  // its P V is done with it
      split_v<W>(st + L::CB * L::BLOCK, v_ring_p + ps * 2 * L::VT_PLANE, tid, rows);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(v_full + 8 * ps);
        mbar_arrive(raw_empty + 8 * s);
      }
      if (tid == 0) issue_upto(n + RS);  // the stage just freed, once every splitter is done
    }
    return;
  }

  // a consumer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F32_CONSUMER_REGS));
  const int c = wg - 1;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr int KS = W / 8;  // S's k-steps along hd
  for (int j = paired ? 0 : c; j < mine; j += paired ? 1 : 2) {
    const int w = (int)blockIdx.x + j * (int)gridDim.x;
    const int item = paired ? w / JT : w, qt = paired ? 2 * (w % JT) + c : 0;
    const auto entry = [&](int ch) {
      return paired ? j * C + ch : 2 * (C * (j / 2) + ch) + c;
    };
    if (qt >= a.q_tiles) {  // an odd count's last job: no tile of its own, the stages passed on
      for (int ch = 0; ch < C; ++ch) {
        const int e = entry(ch), ps = e % PS, par = e / PS & 1;
        mbar_wait(k_full + 8 * ps, par);
        mbar_wait(v_full + 8 * ps, par);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * ps);
          mbar_arrive(v_empty + 8 * ps);
        }
      }
      continue;
    }
    const int b = item / a.H, h = item - b * a.H;
    const int ra = qt * QROWS + 16 * warp + g, rb = ra + 8;  // a lane's rows
    // q's fragments: k-step kk's a0 (ra, 8kk + t), a1 (rb, 8kk + t), a2
    // (ra, 8kk + t + 4), a3 (rb, 8kk + t + 4); rows past N, columns past hd 0
    float qf[KS][4];
    {
      const float* qh = a.q + b * a.qsb + h * a.qsh;
      const auto at = [&](int r, int col) {
        return r < N && col < a.hd ? qh[r * a.qsn + col] : 0.f;
      };
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qf[kk][0] = at(ra, 8 * kk + t);
        qf[kk][1] = at(rb, 8 * kk + t);
        qf[kk][2] = at(ra, 8 * kk + t + 4);
        qf[kk][3] = at(rb, 8 * kk + t + 4);
      }
    }
    // O unnormalised (a lane's rows ra (o[4j], o[4j + 1]) and rb (o[4j + 2],
    // o[4j + 3]), columns 8j + 2t and + 1), the running row max m and the
    // lane's part of the row sum l
    float o[W / 2];
#pragma unroll
    for (int j = 0; j < W / 2; ++j) o[j] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // chunk ch's first NKC keys (all KC of it, or the narrow last chunk's
    // KC / 2)
    const auto chunk = [&](auto nkc, int ch) {
      constexpr int NKC = decltype(nkc)::value, NT = NKC / 8;  // P V's k-steps
      const int e = entry(ch), ps = e % PS, par = e / PS & 1;
      const uint32_t kp = k_ring + ps * 2 * L::K_PLANE, vp = v_ring + ps * 2 * L::VT_PLANE;
      // q's split is made afresh each chunk, not held (ptxas would hoist it
      // out of the loop into W registers more)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_operand(qf[kk][r]);

      // S = Q K^T over the chunk: s[4j..4j+3] keys 8j + 2t, + 1 of rows ra, rb
      float s[NKC / 2], sp[L::SP][NKC / 2];
#pragma unroll
      for (int j = 0; j < NKC / 2; ++j) s[j] = 0.f;
      mbar_wait(k_full + 8 * ps, par);
      run_groups<KS, L::SP>(
          [&](auto kc) {
            constexpr int kk = decltype(kc)::value;
            uint32_t hi[4], lo[4];
            split_fragment(qf[kk], hi, lo);
            const uint32_t kb = kp + kk / 4 * L::BLOCK + kk % 4 * 32;  // 32 bytes a k-step
            tf32x3_step<NKC>(sp[kk % L::SP], hi, lo, wgmma_desc(kb), wgmma_desc(kb + L::K_PLANE));
          },
          [&](auto kc) { add_partial(s, sp[decltype(kc)::value % L::SP]); });
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty + 8 * ps);  // every wgmma that read it has retired

      // the online softmax: keys past N at -inf (every chunk holds a key
      // below N, so the new maxima are finite)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = ch * KC + 8 * j + 2 * t;
        if (col >= N) s[4 * j] = s[4 * j + 2] = -INFINITY;
        if (col + 1 >= N) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
      const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);  // 0 on the first chunk
      m0 = n0;
      m1 = n1;
      l0 = __fmul_rn(l0, a0);  // rounded, never fused into the adds after
      l1 = __fmul_rn(l1, a1);
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        o[4 * j] = __fmul_rn(o[4 * j], a0);
        o[4 * j + 1] = __fmul_rn(o[4 * j + 1], a0);
        o[4 * j + 2] = __fmul_rn(o[4 * j + 2], a1);
        o[4 * j + 3] = __fmul_rn(o[4 * j + 3], a1);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[4 * j] = expf(s[4 * j] - n0);
        s[4 * j + 1] = expf(s[4 * j + 1] - n0);
        s[4 * j + 2] = expf(s[4 * j + 2] - n1);
        s[4 * j + 3] = expf(s[4 * j + 3] - n1);
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
      }

      // O += P V: step j's A fragment is keys 2t (a0, a1) and 2t + 1 (a2,
      // a3) of rows ra, rb, which V^T's planes hold at k-indices t and t + 4
      float op[L::VP][W / 2];
      mbar_wait(v_full + 8 * ps, par);
      run_groups<NT, L::VP>(
          [&](auto jc) {
            constexpr int j = decltype(jc)::value;
            const float p[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
            uint32_t hi[4], lo[4];
            split_fragment(p, hi, lo);
            const uint32_t vb = vp + j / 4 * L::VT_BLOCK + j % 4 * 32;  // 32 bytes a k-step
            tf32x3_step<W>(op[j % L::VP], hi, lo, wgmma_desc(vb), wgmma_desc(vb + L::VT_PLANE));
          },
          [&](auto jc) { add_partial(o, op[decltype(jc)::value % L::VP]); });
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * ps);
    };
    for (int ch = 0; ch < C; ++ch) {
      if (narrow_last(ch))
        chunk(std::integral_constant<int, KC / 2>{}, ch);
      else
        chunk(std::integral_constant<int, KC>{}, ch);
    }

    // O / l, rows past N and columns past hd left out
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= a.hd) continue;
      if (ra < N)
        *reinterpret_cast<float2*>(a.out + (((size_t)b * N + ra) * a.H + h) * a.hd + col) =
            make_float2(o[4 * j] / l0, o[4 * j + 1] / l0);
      if (rb < N)
        *reinterpret_cast<float2*>(a.out + (((size_t)b * N + rb) * a.H + h) * a.hd + col) =
            make_float2(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 body for heads wider than 80 (mma.sync, 3xTF32)
// ---------------------------------------------------------------------------

constexpr int KC = 32;               // keys per chunk

// The float32 body's layout at head width W and DV output columns a block:
// row strides of W + 4 and DV + 4 floats; a chunk buffer holds KC K rows,
// then KC V rows; up to W = 96 the q tile is staged in the second chunk
// buffer before its first use and split into registers, beyond it keeps a
// region of its own after the two buffers.
template <int W, int DV>
struct F32Body {
  static constexpr int LDK = W + 4, LDV = DV + 4;
  static constexpr int BUF = KC * LDK + KC * LDV;  // floats of one chunk buffer
  static constexpr bool Q_REGS = W <= 96;
  static constexpr size_t SMEM = (size_t)(2 * BUF + (Q_REGS ? 0 : QROWS * LDK)) * sizeof(float);
  static_assert(!Q_REGS || QROWS * LDK <= BUF, "the q tile is staged in the second chunk buffer");
};

// rows [r0, r0 + rows) and columns [col0, col0 + W) of one head into a
// (rows x W) float32 tile of row stride ld; rows at or past N and columns at
// or past hd are zero
template <int W>
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, const float* src,
                                               long long sn, int r0, int rows, int N, int col0,
                                               int hd) {
  constexpr int CH = W / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e - r * CH;
    float* d = dst + r * ld + c * 4;
    if (r0 + r < N && col0 + c * 4 < hd)
      cp_async16(smem_u32(d), src + (r0 + r) * sn + col0 + c * 4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// o += P V over one 8-key step whose P accumulators are p: a lane holds
// keys 2t and 2t + 1 of the step, which A's k-indices t and t + 4 stand
// for, and V's B fragment rows are read in that order from vr (key 2t of
// the step, column g), rows LDV floats apart
template <int DV, int LDV>
__device__ __forceinline__ void pv_step(float (&o)[DV / 8][4], const float (&p)[4],
                                        const float* vr) {
  uint32_t a_hi[4], a_lo[4];
  split_tf32(p[0], a_hi[0], a_lo[0]);  // row g,     key 2t
  split_tf32(p[2], a_hi[1], a_lo[1]);  // row g + 8, key 2t
  split_tf32(p[1], a_hi[2], a_lo[2]);  // row g,     key 2t + 1
  split_tf32(p[3], a_hi[3], a_lo[3]);  // row g + 8, key 2t + 1
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn) {
    uint32_t b_hi[2], b_lo[2];
    split_tf32(vr[8 * dn], b_hi[0], b_lo[0]);        // key 2t, column 8 dn + g
    split_tf32(vr[LDV + 8 * dn], b_hi[1], b_lo[1]);  // key 2t + 1
    mma_tf32x3(o[dn], a_hi, a_lo, b_hi, b_lo);
  }
}

// the A fragment (rows g and g + 8, columns t and t + 4) of the q tile at
// qw (row g, column t), split
__device__ __forceinline__ void split_q(const float* qw, int ld, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_tf32(qw[0], hi[0], lo[0]);
  split_tf32(qw[8 * ld], hi[1], lo[1]);
  split_tf32(qw[4], hi[2], lo[2]);
  split_tf32(qw[8 * ld + 4], hi[3], lo[3]);
}

template <int W, int DV>
__global__ void __launch_bounds__(THREADS, 2)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H, int N, int hd,
                  int q_tiles, int col_chunks, long long qsb, long long qsn, long long qsh,
                  long long ksb, long long ksn, long long ksh,
                  long long vsb, long long vsn, long long vsh) {
  typedef F32Body<W, DV> L;
  constexpr int LDK = L::LDK, LDV = L::LDV;
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  float* q_s = buf + (L::Q_REGS ? 1 : 2) * L::BUF;

  const int dc = blockIdx.x % col_chunks, tile = blockIdx.x / col_chunks;
  const int bh = tile / q_tiles, qt = tile - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int r0 = qt * QROWS, d0 = dc * DV;
  const float* kh = k + b * ksb + h * ksh;
  const float* vh = v + b * vsb + h * vsh;
  const int chunks = (N + KC - 1) / KC;
  auto stage_chunk = [&](int c) {
    float* dst = buf + (c & 1) * L::BUF;
    stage_rows_f32<W>(dst, LDK, kh, ksn, c * KC, KC, N, 0, hd);
    stage_rows_f32<DV>(dst + KC * LDK, LDV, vh, vsn, c * KC, KC, N, d0, hd);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage_rows_f32<W>(q_s, LDK, q + b * qsb + h * qsh, qsn, r0, QROWS, N, 0, hd);
  stage_chunk(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = r0 + warp * 16 < N;  // uniform across the warp
  const float* qw = q_s + (warp * 16 + g) * LDK + t;

  // the warp's q fragments, split once: k-step kk of 8 along hd (up to W =
  // 96; a wider q tile stays in shared memory)
  uint32_t q_hi[L::Q_REGS ? W / 8 : 1][4], q_lo[L::Q_REGS ? W / 8 : 1][4];
  if constexpr (L::Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < W / 8; ++kk) split_q(qw + 8 * kk, LDK, q_hi[kk], q_lo[kk]);
  }

  // online softmax over chunks of KC keys: m the running row max, l the
  // lane's part of the row sum of exp(s - m), o the unnormalised output
  float o[DV / 8][4];
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int c = 0; c < chunks; ++c) {
    if (c > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    // chunk c has landed, and every warp is done with chunk c - 1 (or q)
    __syncthreads();
    if (c + 1 < chunks) stage_chunk(c + 1);  // into the buffer chunk c - 1 (or q) held
    if (!active) continue;
    const float* kc = buf + (c & 1) * L::BUF;
    const float* vc = kc + KC * LDK;
    const int nt = min(KC / 8, (N - c * KC + 7) / 8);  // 8-key tiles holding a key < N

    // S = Q K^T over the chunk; tile j holds keys 8j..8j+7 of the chunk, a
    // lane rows g and g + 8, columns 2t and 2t + 1
    float s[KC / 8][4];
    if constexpr (L::Q_REGS) {
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if (j >= nt) continue;
        const float* kw = kc + (8 * j + g) * LDK + t;
#pragma unroll
        for (int kk = 0; kk < W / 8; ++kk) {
          uint32_t b_hi[2], b_lo[2];
          split_tf32(kw[8 * kk], b_hi[0], b_lo[0]);
          split_tf32(kw[8 * kk + 4], b_hi[1], b_lo[1]);
          mma_tf32x3(s[j], q_hi[kk], q_lo[kk], b_hi, b_lo);
        }
      }
    } else {
      // each k-step's q fragment split once for the chunk's 8-key tiles;
      // every tile still sums its k-steps in order
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < W / 8; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        split_q(qw + 8 * kk, LDK, a_hi, a_lo);
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          if (j >= nt) continue;
          const float* kw = kc + (8 * j + g) * LDK + t + 8 * kk;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(kw[0], b_hi[0], b_lo[0]);
          split_tf32(kw[4], b_hi[1], b_lo[1]);
          mma_tf32x3(s[j], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const int col = c * KC + 8 * j + 2 * t;
      if (col >= N) s[j][0] = s[j][2] = -INFINITY;
      if (col + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // every chunk holds a key < N, so the new maxima are finite
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);  // 0 on the first chunk
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dn = 0; dn < DV / 8; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      s[j][0] = expf(s[j][0] - n0);
      s[j][1] = expf(s[j][1] - n0);
      s[j][2] = expf(s[j][2] - n1);
      s[j][3] = expf(s[j][3] - n1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V
    const float* vw = vc + 2 * t * LDV + g;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
      if (j < nt) pv_step<DV, LDV>(o, s[j], vw + 8 * j * LDV);
  }
  if (!active) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < DV / 8; ++dn) {
    const int col = d0 + 8 * dn + 2 * t;
    if (col >= hd) continue;
    if (row0 < N)
      *reinterpret_cast<float2*>(out + (((size_t)b * N + row0) * H + h) * hd + col) =
          make_float2(o[dn][0] / l0, o[dn][1] / l0);
    if (row1 < N)
      *reinterpret_cast<float2*>(out + (((size_t)b * N + row1) * H + h) * hd + col) =
          make_float2(o[dn][2] / l1, o[dn][3] / l1);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, H, N, hd;
  long long qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh;
  cudaStream_t stream;
};

// the head width a query-tiled body is built for: hd rounded up to the next
// of 64, 80, 96, 128 and 256
int body_width(int hd) {
  return hd <= 64 ? 64 : hd <= 80 ? 80 : hd <= 96 ? 96 : hd <= 128 ? 128 : 256;
}

template <typename Fn>
int with_width(int hd, Fn&& f) {
  switch (body_width(hd)) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, 256>{});
  }
}

// output columns a block of a query-tiled body at head width W computes
constexpr int col_width(int W) { return W < COL_CHUNK ? W : COL_CHUNK; }

// (q_tiles, col_chunks) of a query-tiled launch
inline int q_tiles_of(int N) { return (N + QROWS - 1) / QROWS; }
inline int col_chunks_of(int hd) { return (hd + col_width(body_width(hd)) - 1) / col_width(body_width(hd)); }

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int W>
int launch_bf16_long(const Args& a) {
  constexpr int DV = col_width(W);
  const int q_tiles = q_tiles_of(a.N), col_chunks = col_chunks_of(a.hd);
  const size_t smem = LongBody<W, DV>::SMEM;
  int err = set_smem(attention_fwd_bf16_long<W, DV>, smem);
  if (err != 0) return err;
  attention_fwd_bf16_long<W, DV><<<a.B * a.H * q_tiles * col_chunks, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.H, a.N, a.hd, q_tiles,
      col_chunks, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh);
  return (int)cudaGetLastError();
}

// the TMA map of a (B, N, H, hd) bf16 (or, with f32, float32) operand with
// (batch, token, head) element strides sb, sn, sh: boxes of one 128-byte row
// of columns (64 bf16, 32 float32) by `rows` tokens of one head, in the
// 128-byte swizzle; columns past hd and tokens past N read as zeros
// (tma.cuh's tensor_map, which keeps the maps it encoded)
int head_map(CUtensorMap* map, const void* base, const Args& a, long long sb, long long sn,
             long long sh, int rows, bool f32 = false) {
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)a.hd, (cuuint64_t)a.H, (cuuint64_t)a.N, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * es, (cuuint64_t)sn * es, (cuuint64_t)sb * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), 1, (cuuint32_t)rows, 1};
  return tensor_map(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    4, base, dims, strides, box, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

template <int ST>
int launch_bf16_smem(const Args& a) {
  const int q_tiles = q_tiles_of(a.N);
  const size_t smem = SmemBody::bytes(a.N, ST);
  int err = set_smem(attention_fwd_bf16_smem<ST>, smem);
  if (err != 0) return err;
  const SmemArgs sa{static_cast<const bf16*>(a.q), static_cast<bf16*>(a.out), a.H, a.N, a.hd,
                    q_tiles, a.qsb, a.qsn, a.qsh};
  CUtensorMap kmap, vmap;
  if ((err = head_map(&kmap, a.k, a, a.ksb, a.ksn, a.ksh, SmemBody::KW)) != 0) return err;
  if ((err = head_map(&vmap, a.v, a, a.vsb, a.vsn, a.vsh, SmemBody::KW)) != 0) return err;
  attention_fwd_bf16_smem<ST><<<a.B * a.H * q_tiles, SmemBody::WGS * THREADS, smem,
                               a.stream>>>(sa, kmap, vmap);
  return (int)cudaGetLastError();
}

template <int NK>
int launch_bf16_tma(const Args& a) {
  typedef TmaBody<NK> L;
  int err = set_smem(attention_fwd_bf16_tma<NK>, L::SMEM);
  int sms = 0;
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  const TmaArgs ta{static_cast<bf16*>(a.out), a.H, a.N, a.hd, a.B * a.H};
  CUtensorMap qmap, kmap, vmap;
  if ((err = head_map(&qmap, a.q, a, a.qsb, a.qsn, a.qsh, QROWS)) != 0) return err;
  if ((err = head_map(&kmap, a.k, a, a.ksb, a.ksn, a.ksh, L::KV_BOX)) != 0) return err;
  if ((err = head_map(&vmap, a.v, a, a.vsb, a.vsn, a.vsh, L::KV_BOX)) != 0) return err;
  attention_fwd_bf16_tma<NK><<<ta.items < sms ? ta.items : sms, TMA_THREADS, L::SMEM,
                               a.stream>>>(ta, qmap, kmap, vmap);
  return (int)cudaGetLastError();
}

template <int W>
int launch_f32_tma(const Args& a) {
  typedef F32TmaBody<W> L;
  int err = set_smem(attention_fwd_f32_tma<W>, L::SMEM);
  int sms = 0;
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  // jobs of two query tiles where an item has more than one, else its
  // units (a (batch, head) of one query tile each)
  const int q_tiles = q_tiles_of(a.N);
  const int work = a.B * a.H * (q_tiles > 1 ? (q_tiles + 1) / 2 : 1);
  const F32Args fa{static_cast<const float*>(a.q), static_cast<float*>(a.out), a.H, a.N, a.hd,
                   q_tiles, work, a.qsb, a.qsn, a.qsh};
  CUtensorMap kmap, vmap;
  if ((err = head_map(&kmap, a.k, a, a.ksb, a.ksn, a.ksh, L::KC, true)) != 0) return err;
  if ((err = head_map(&vmap, a.v, a, a.vsb, a.vsn, a.vsh, L::KC, true)) != 0) return err;
  attention_fwd_f32_tma<W><<<work < sms ? work : sms, TMA_THREADS, L::SMEM, a.stream>>>(
      fa, kmap, vmap);
  return (int)cudaGetLastError();
}

template <int W>
int launch_f32(const Args& a) {
  constexpr int DV = col_width(W);
  const int q_tiles = q_tiles_of(a.N), col_chunks = col_chunks_of(a.hd);
  const size_t smem = F32Body<W, DV>::SMEM;
  int err = set_smem(attention_fwd_f32<W, DV>, smem);
  if (err != 0) return err;
  attention_fwd_f32<W, DV><<<a.B * a.H * q_tiles * col_chunks, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.H, a.N, a.hd, q_tiles,
      col_chunks, a.qsb, a.qsn, a.qsh, a.ksb, a.ksn, a.ksh, a.vsb, a.vsn, a.vsh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v: (B, N, H, hd) with the given
// element strides for batch, token and head (unit stride inside a head);
// out: contiguous (B, N, H, hd); any N >= 1, 1 <= hd <= 256 with hd a
// multiple of 8 elements in bfloat16 and of 4 in float32 (16 bytes: ops/
// attention.py zero-pads any other hd).  Every body copies 16-byte chunks
// of rows, so every base pointer must be 16-byte aligned and every stride a
// multiple of 16 bytes (8 bf16 or 4 float32 elements).  The grid (one
// block an SM, at most B * H, for the bf16 persistent body up to
// TMA_MAX_SEQ at hd <= 64, which counts its B * H items; per (batch, head,
// 64-query tile) for the bf16 body with S in shared memory beyond, up to
// SMEM2_MAX_SEQ at hd <= 64; per (batch, head, 64-query tile, chunk of at
// most 128 output columns) otherwise) holds at most 2^31 - 1 blocks or
// items.  Returns the CUDA error code (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, int dtype,
                             int B, int H, int N, int hd, long long qsb, long long qsn,
                             long long qsh, long long ksb, long long ksn, long long ksh,
                             long long vsb, long long vsn, long long vsh, void* stream) {
  if (B < 1 || H < 1 || N < 1 || hd < 1 || hd > MAX_HD) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long chunk = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (hd % chunk != 0) return (int)cudaErrorInvalidValue;
  const bool narrow = dtype == 1 && hd <= REG_WIDTH;  // bf16 heads of up to 64
  const bool tma = narrow && N <= TMA_MAX_SEQ;
  const bool in_smem = narrow && !tma && N <= SMEM2_MAX_SEQ;
  const long long blocks =
      (long long)B * H * (tma ? 1 : (long long)q_tiles_of(N) * (in_smem ? 1 : col_chunks_of(hd)));
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)) ||
      ((qsb | qsn | qsh | ksb | ksn | ksh | vsb | vsn | vsh) & (chunk - 1)))
    return (int)cudaErrorMisalignedAddress;
  const Args a{q, k, v, out, B, H, N, hd, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    switch (body_width(hd)) {
      case 64: return launch_f32_tma<64>(a);
      case 80: return launch_f32_tma<80>(a);
      case 96: return launch_f32<96>(a);
      case 128: return launch_f32<128>(a);
      default: return launch_f32<256>(a);
    }
  }
  if (tma) {
    if (N <= 56) return launch_bf16_tma<56>(a);
    if (N <= 64) return launch_bf16_tma<64>(a);
    if (N <= 128) return launch_bf16_tma<128>(a);
    if (N <= 200) return launch_bf16_tma<200>(a);
    return launch_bf16_tma<264>(a);
  }
  if (in_smem)
    return N <= SMEM_MAX_SEQ ? launch_bf16_smem<RING>(a) : launch_bf16_smem<SHORT_RING>(a);
  return with_width(hd, [&](auto w) { return launch_bf16_long<decltype(w)::value>(a); });
}
