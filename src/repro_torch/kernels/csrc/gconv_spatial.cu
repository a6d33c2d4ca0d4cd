// Spatial GCONV kernel for Hopper (sm_90a): direct NHWC convolution, f32 on
// the CUDA cores, with overlap reuse in shared memory and no im2col.
//
// Replaces the JAX package's Pallas kernel src/repro/kernels/gconv_spatial.py
// (_gconv_spatial / _kernel):
//
//   out[b, oh, ow, o] = sum_{kh, kw, c} xpad[b, oh*s + kh, ow*s + kw, c]
//                                       * w[kh, kw, c, o]
//
// with x (B, H, W, C), w (KH, KW, C, O) and out (B, OH, OW, O), all f32 and
// contiguous; square stride s, symmetric zero padding, groups 1.
//
// The Pallas kernel keeps one whole padded image per grid step; a Hopper
// block has at most 227 KB of shared memory, so this kernel tiles the
// output instead: one block computes TH x TW output positions of one image
// times BO output channels. For each chunk of CC input channels it stages
// the tile's input halo, ((TH-1)*s + KH) x ((TW-1)*s + KW) x CC, in shared
// memory once, and every (kh, kw) tap reads shifted views of that one halo
// against a (CC, BO) weight slice: the overlap reuse the paper argues for.
// Padding, stride, and O, C or spatial remainders are masked.
//
// What bounds it: at GoogLeNet's shapes (C 16..192, O 32..384, 3x3 and 5x5)
// the work is 2*B*OH*OW*O*KH*KW*C flops on x + w + out bytes, bound by
// operations at the f32 CUDA-core rate. Each thread keeps 4 positions x 4
// channels in registers. Tensor cores, TMA and double-buffered halos are
// later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Mirrored by TILE_H, TILE_W, BLOCK_O in kernels/gconv_spatial.py.
constexpr int TH = 8;
constexpr int TW = 8;
constexpr int BO = 64;
constexpr int THREADS = 256;
constexpr int TP = 4;  // positions per thread, strided by (TH*TW) / TP
constexpr int TO = 4;  // channels per thread, strided by BO / TO

__global__ void __launch_bounds__(THREADS)
gconv_spatial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int H, int W, int C, int O,
                     int KH, int KW, int stride, int pad, int OH, int OW,
                     int tiles_w, int CC) {
  extern __shared__ float smem[];
  const int halo_h = (TH - 1) * stride + KH;
  const int halo_w = (TW - 1) * stride + KW;
  float* xs = smem;                              // [halo_h][halo_w][CC]
  float* ws = smem + (size_t)halo_h * halo_w * CC;  // [CC][BO]

  const int b = blockIdx.z;
  const int oh0 = (blockIdx.y / tiles_w) * TH;
  const int ow0 = (blockIdx.y % tiles_w) * TW;
  const int o0 = blockIdx.x * BO;
  const int tid = threadIdx.x;
  const int tx = tid % (BO / TO);
  const int ty = tid / (BO / TO);
  const int ih0 = oh0 * stride - pad;
  const int iw0 = ow0 * stride - pad;
  const float* xb = x + (size_t)b * H * W * C;

  // halo offset of each of this thread's output positions (tap (0, 0))
  int base[TP];
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int p = ty + i * ((TH * TW) / TP);
    base[i] = ((p / TW) * stride * halo_w + (p % TW) * stride) * CC;
  }

  float acc[TP][TO];
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < TO; ++j) acc[i][j] = 0.0f;

  const int n_halo = halo_h * halo_w * CC;
  for (int c0 = 0; c0 < C; c0 += CC) {
    // stage the halo once per channel chunk; CC is innermost, as in NHWC
    for (int idx = tid; idx < n_halo; idx += THREADS) {
      const int cc = idx % CC;
      const int pos = idx / CC;
      const int ih = ih0 + pos / halo_w;
      const int iw = iw0 + pos % halo_w;
      const int c = c0 + cc;
      float v = 0.0f;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W && c < C)
        v = xb[((size_t)ih * W + iw) * C + c];
      xs[idx] = v;
    }
    for (int kh = 0; kh < KH; ++kh) {
      for (int kw = 0; kw < KW; ++kw) {
        __syncthreads();  // the last tap is done with ws; the halo is stored
        const float* wt = w + ((size_t)kh * KW + kw) * C * O;
        for (int idx = tid; idx < CC * BO; idx += THREADS) {
          const int oo = idx % BO, cc = idx / BO;
          const int c = c0 + cc, o = o0 + oo;
          ws[idx] = (c < C && o < O) ? wt[(size_t)c * O + o] : 0.0f;
        }
        __syncthreads();
        const int shift = (kh * halo_w + kw) * CC;  // this tap's view
        for (int cc = 0; cc < CC; ++cc) {
          float a[TP], bv[TO];
#pragma unroll
          for (int i = 0; i < TP; ++i) a[i] = xs[base[i] + shift + cc];
#pragma unroll
          for (int j = 0; j < TO; ++j) bv[j] = ws[cc * BO + tx + j * (BO / TO)];
#pragma unroll
          for (int i = 0; i < TP; ++i)
#pragma unroll
            for (int j = 0; j < TO; ++j)
              acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every tap is done with the halo before the next chunk
  }

#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int p = ty + i * ((TH * TW) / TP);
    const int oh = oh0 + p / TW, ow = ow0 + p % TW;
    if (oh >= OH || ow >= OW) continue;
    float* orow = out + (((size_t)b * OH + oh) * OW + ow) * O;
#pragma unroll
    for (int j = 0; j < TO; ++j) {
      const int o = o0 + tx + j * (BO / TO);
      if (o < O) orow[o] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the kernel needs for channel chunk CC.
size_t gconv_spatial_smem_bytes(int KH, int KW, int stride, int CC) {
  const size_t halo = (size_t)((TH - 1) * stride + KH) * ((TW - 1) * stride + KW);
  return (halo * CC + (size_t)CC * BO) * sizeof(float);
}

// Launch on ``stream``; returns the cudaError_t of the launch (0 = queued).
int gconv_spatial_launch(const float* x, const float* w, float* out, int B,
                         int H, int W, int C, int O, int KH, int KW,
                         int stride, int pad, int OH, int OW, int CC,
                         void* stream) {
  if (B < 1 || B > 65535 || C < 1 || O < 1 || KH < 1 || KW < 1 ||
      stride < 1 || pad < 0 || OH < 1 || OW < 1 || CC < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_h = (OH + TH - 1) / TH;
  const int tiles_w = (OW + TW - 1) / TW;
  if ((long long)tiles_h * tiles_w > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = gconv_spatial_smem_bytes(KH, KW, stride, CC);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gconv_spatial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((O + BO - 1) / BO, tiles_h * tiles_w, B);
  gconv_spatial_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w, out, H, W, C, O, KH, KW, stride, pad, OH, OW, tiles_w, CC);
  return (int)cudaGetLastError();
}

const char* gconv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
