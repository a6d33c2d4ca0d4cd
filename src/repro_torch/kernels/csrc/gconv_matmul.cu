// Grouped GCONV matmul for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces the JAX package's Pallas kernel src/repro/kernels/gconv_matmul.py
// (_gconv_matmul / _kernel):
//
//   out[g] = epilogue(post(scale * (prologue(x)[g] @ w[g])))
//
// with x (G, M, K), w (G, K, N) and out (G, M, N), all f32 and contiguous.
// The prologue applies to every loaded x element with k < K; elements past K
// (and past M) count as 0 after it, because a prologue op need not map 0 to
// 0. The epilogue order is scale, then the single-op ``post``, then the
// epilogue sequence, as in the Pallas kernel.
//
// Fused ops arrive as a FusedSeq passed by value: opcode, constant, operand
// pointer, broadcast kind and a group stride of 0 or 1 per op. The kernel
// switches over them, so one build serves every sequence. Opcodes follow
// OPCODES in kernels/gconv_matmul.py (the UNARY vocabulary of
// core/operators.py in its order).
//
// What bounds it: the GoogLeNet shapes (M 32..25088, K 256..1024,
// N 128..1000) do 2*M*N*K flops on 4*(M*K + K*N + M*N) bytes, so they are
// bound by operations at the f32 CUDA-core rate. This first version keeps a
// 64x64 output tile per block in registers (4x4 per thread), stages 16-deep
// slices of x and w through shared memory, and loops over K inside the
// block (the Pallas grid's sequential K axis; nothing carries over between
// blocks). Tensor cores (wgmma), TMA and a deeper pipeline are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define MAX_OPS 16

enum OperandKind { KIND_NONE = 0, KIND_SCALAR = 1, KIND_ROW = 2, KIND_COL = 3 };

// Layout mirrored by the ctypes Structure in kernels/gconv_matmul.py.
struct FusedSeq {
  int n;
  int code[MAX_OPS];
  int kind[MAX_OPS];     // OperandKind; KIND_COL reads along K (prologue)
                         // or N (epilogue)
  int gstride[MAX_OPS];  // 1: the operand has a G axis; 0: shared
  float cst[MAX_OPS];
  const float* ptr[MAX_OPS];
};

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4;  // rows per thread, strided by BM / TM
constexpr int TN = 4;  // cols per thread, strided by BN / TN

// NaN handling follows jnp/torch: relu, clip_max and maximum propagate it.
__device__ __forceinline__ float apply_op(int code, float x, float c, float p) {
  switch (code) {
    case 0: return x;                                        // id
    case 1: return -x;                                       // neg
    case 2: return fabsf(x);                                 // abs
    case 3: return x * x;                                    // square
    case 4: return sqrtf(x);                                 // sqrt
    case 5: return 1.0f / x;                                 // recip
    case 6: return expf(x);                                  // exp
    case 7: return logf(x);                                  // log
    case 8: return x < 0.0f ? 0.0f : x;                      // relu
    case 9: return x > 0.0f ? 1.0f : 0.0f;                   // gtz
    case 10: return 1.0f / (1.0f + expf(-x));                // sigmoid
    case 11: return x / (1.0f + expf(-x));                   // silu
    case 12: {                                               // gelu (tanh)
      const float k0 = 0.7978845608028654f;                  // sqrt(2/pi)
      return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
    }
    case 13: return tanhf(x);                                // tanh
    case 14: return x * c;                                   // scale
    case 15: return x + c;                                   // add_const
    case 16: return powf(x, c);                              // pow
    case 17: return 1.0f / sqrtf(x + c);                     // rsqrt_eps
    case 18: return x >= 0.0f ? x : x * c;                   // leaky_relu
    case 19: return x > c ? c : x;                           // clip_max
    case 20: return x * p;                                   // mul
    case 21: return x + p;                                   // add
    case 22: return x - p;                                   // sub
    case 23: return p - x;                                   // rsub
    case 24: return x / p;                                   // div
    case 25: return (x > p || x != x) ? x : p;               // maximum
    default: return __int_as_float(0x7fc00000);              // unreachable
  }
}

// Apply a fused sequence to the element at (g, row, col); ``cols`` is K for
// the prologue and N for the epilogue.
__device__ __forceinline__ float apply_seq(const FusedSeq& s, float v, int g,
                                           int row, int col, int rows,
                                           int cols) {
  for (int i = 0; i < s.n; ++i) {
    float p = 0.0f;
    const float* base = s.ptr[i];
    const size_t gi = (size_t)g * s.gstride[i];
    switch (s.kind[i]) {
      case KIND_SCALAR: p = base[gi]; break;
      case KIND_ROW: p = base[gi * rows + row]; break;
      case KIND_COL: p = base[gi * cols + col]; break;
      default: break;
    }
    v = apply_op(s.code[i], v, s.cst[i], p);
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
gconv_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int M, int K, int N, float scale,
                    int post, const __grid_constant__ FusedSeq pro,
                    const __grid_constant__ FusedSeq epi) {
  // __grid_constant__: the op tables are read in place from parameter
  // space (apply_seq indexes them at run time) instead of being copied to
  // each thread's local memory.
  __shared__ float xs[BK][BM + 4];  // x tile, k-major; +4 spreads the stores
  __shared__ float ws[BK][BN];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float* xg = x + (size_t)g * M * K;
  const float* wg = w + (size_t)g * K * N;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice: neighbouring threads read neighbouring k (coalesced)
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int mm = idx / BK, kk = idx % BK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < K) {
        v = xg[(size_t)m * K + k];
        if (pro.n) v = apply_seq(pro, v, g, m, k, M, K);
      }
      xs[kk][mm] = v;
    }
    // w slice: neighbouring threads read neighbouring n
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN, nn = idx % BN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = (k < K && n < N) ? wg[(size_t)k * N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* og = out + (size_t)g * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * (BN / TN);
      if (n >= N) continue;
      float y = acc[i][j];
      if (scale != 1.0f) y *= scale;
      y = apply_op(post, y, 0.0f, 0.0f);
      if (epi.n) y = apply_seq(epi, y, g, m, n, M, N);
      og[(size_t)m * N + n] = y;
    }
  }
}

}  // namespace

extern "C" {

// Launch on ``stream``; returns the cudaError_t of the launch (0 = queued).
int gconv_matmul_launch(const float* x, const float* w, float* out, int G,
                        int M, int K, int N, float scale, int post,
                        const FusedSeq* pro, const FusedSeq* epi,
                        void* stream) {
  if (G < 1 || G > 65535 || M < 1 || (M + BM - 1) / BM > 65535 || N < 1 ||
      K < 0 || pro->n < 0 || pro->n > MAX_OPS || epi->n < 0 ||
      epi->n > MAX_OPS)
    return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  gconv_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, out, M, K, N, scale, post, *pro, *epi);
  return (int)cudaGetLastError();
}

const char* gconv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gconv_matmul_max_ops(void) { return MAX_OPS; }

}  // extern "C"
