// Fused multi-sweep red-black SOR for 2-D stencils, for NVIDIA Hopper
// (sm_90a), called from JAX through the XLA FFI.
//
// One launch runs `sweeps` full red-black iterations.  Each block owns a
// tile_y x tile_x tile of one batch slice and stages a win_y x win_x window
// (the tile plus a ghost cone of `halo` = 2 * radius * sweeps cells on every
// side) of the state S and of the K weight planes, w0, g and omega*relax in
// shared memory.  It runs the sweeps there, with a block barrier between the
// half-sweeps, and writes back only its own tile: each red-black iteration
// moves information at most 2 * radius cells, so the owned tile is exact.
//
// The window geometry (which rows and columns each block reads, which blocks
// see the extend rows) is the Python plan in ops/sor2d.py; its jnp executor
// `launch_jnp` is this kernel's arithmetic reference.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libsor2d.so sor2d.cu
// (ops/cuda_build.py runs it at first use.)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <string>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxAll = 16;   // window points per thread (load, extend, store)
constexpr int kMaxHalf = 8;   // colour points per thread per half-sweep
constexpr int kMaxK = 24;     // neighbour offsets
constexpr int kMaxSmem = 226 * 1024;  // of the 227 KB opt-in, 1 KB left for static shared memory

struct Params {
  int ny, nx, K, sweeps;
  int tile_y, tile_x, halo, win_y, win_x;
  int periodic_x, extend_y, bih, radius, same_color;
  int dy[kMaxK], dx[kMaxK];
  long long w_kstride, w_bstride, w0_bstride, g_bstride, r_bstride;
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// Local index of the cell the extend pre-pass copies into window cell
// (ly, lx), or -1 when the cell is not on an extend row (or its source lies
// outside the window: then the cell is outside the tile's dependence cone).
// Mirrors solver._apply_extend: rows 0 / ny-1 (two rows each end for the
// biharmonic ring) copy the nearest interior row, with the column clamped
// into the interior when x is not periodic.
__device__ __forceinline__ int extend_src(const Params& p, int ly, int lx,
                                          int y0, int x0) {
  const int gy = y0 + ly;
  int sy;
  if (!p.bih) {
    if (gy == 0) sy = 1;
    else if (gy == p.ny - 1) sy = p.ny - 2;
    else return -1;
  } else {
    if (gy == 0) sy = p.periodic_x ? 1 : 2;
    else if (gy == 1) sy = 2;
    else if (gy >= p.ny - 2) sy = p.ny - 3;
    else return -1;
  }
  int dxs = 0;
  if (!p.periodic_x) {
    const int gx = x0 + lx;
    const int lo = p.bih ? 2 : 1;
    const int sx = min(max(gx, lo), p.nx - 1 - lo);
    dxs = sx - gx;
  }
  const int sly = ly + (sy - gy), slx = lx + dxs;
  if (sly < 0 || sly >= p.win_y || slx < 0 || slx >= p.win_x) return -1;
  return sly * p.win_x + slx;
}

// KT > 0: the offset count is a compile-time constant (the common 4-, 8-
// and 12-offset stencils), so the neighbour loop unrolls with its offsets
// in registers; KT == 0 reads K and the offsets at run time.
template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
sor2d_kernel(const float* __restrict__ S, const float* __restrict__ W,
             const float* __restrict__ W0, const float* __restrict__ G,
             const float* __restrict__ R, float* __restrict__ out,
             const Params p) {
  extern __shared__ float sm[];
  const int K = KT > 0 ? KT : p.K;
  const int npts = p.win_y * p.win_x;
  float* sS = sm;
  float* sW = sm + npts;
  float* sW0 = sW + K * npts;
  float* sG = sW0 + npts;
  float* sR = sG + npts;

  const int tid = threadIdx.x;
  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const long long plane = (long long)p.ny * p.nx;
  const int y0 = max(0, min(by * p.tile_y - p.halo, p.ny - p.win_y));
  int x0 = bx * p.tile_x - p.halo;
  if (!p.periodic_x) x0 = max(0, min(x0, p.nx - p.win_x));

  const float* Sb = S + b * plane;
  const float* Wb = W + b * p.w_bstride;
  const float* W0b = W0 + b * p.w0_bstride;
  const float* Gb = G + b * p.g_bstride;
  const float* Rb = R + b * p.r_bstride;

  // stage the window with asynchronous copies (cp.async): every thread
  // issues all its loads before waiting once, so the block keeps as many
  // requests in flight as the memory system takes
  for (int i = tid; i < npts; i += kThreads) {
    const int ly = i / p.win_x, lx = i - ly * p.win_x;
    int gx = x0 + lx;
    if (p.periodic_x) gx = wrap(gx, p.nx);
    const long long gi = (long long)(y0 + ly) * p.nx + gx;
    __pipeline_memcpy_async(sS + i, Sb + gi, sizeof(float));
    for (int k = 0; k < K; ++k)
      __pipeline_memcpy_async(sW + k * npts + i, Wb + k * p.w_kstride + gi,
                              sizeof(float));
    __pipeline_memcpy_async(sW0 + i, W0b + gi, sizeof(float));
    __pipeline_memcpy_async(sG + i, Gb + gi, sizeof(float));
    __pipeline_memcpy_async(sR + i, Rb + gi, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const bool edge = p.extend_y && (y0 <= 1 || y0 + p.win_y >= p.ny - 2);
  const int r = p.radius;
  const int half_w = (p.win_x + 1) / 2;
  const int nhalf = p.win_y * half_w;
  const int par0 = (y0 + x0) & 1;

  // this thread's half-sweep cells, fixed for the launch: slot j is cell
  // (ly, 2m + parity) of row ly; `upd[c]` marks the slots that colour c
  // updates (inside the window's never-updated edge ring)
  int base[kMaxHalf];
  unsigned odd = 0, upd[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kMaxHalf; ++j) {
    const int q = tid + j * kThreads;
    base[j] = 0;
    if (q < nhalf) {
      const int ly = q / half_w, m = q - ly * half_w;
      base[j] = ly * p.win_x + 2 * m;
      const int pr = (ly + par0) & 1;
      odd |= static_cast<unsigned>(pr) << j;
      if (ly >= r && ly < p.win_y - r) {
        for (int c = 0; c < 2; ++c) {
          const int lx = 2 * m + ((c + pr) & 1);
          if (lx >= r && lx < p.win_x - r) upd[c] |= 1u << j;
        }
      }
    }
  }
  __shared__ int s_off[kMaxK];
  int off[KT > 0 ? KT : 1];
  if (KT > 0) {
#pragma unroll
    for (int k = 0; k < (KT > 0 ? KT : 1); ++k)
      off[k] = p.dy[k] * p.win_x + p.dx[k];
  } else if (tid < p.K) {
    s_off[tid] = p.dy[tid] * p.win_x + p.dx[tid];
  }
  __syncthreads();

  for (int s = 0; s < p.sweeps; ++s) {
    if (edge) {
      // extend pre-pass: every source is read before any row is written
      float v[kMaxAll];
      int dst[kMaxAll];
#pragma unroll
      for (int j = 0; j < kMaxAll; ++j) {
        const int i = tid + j * kThreads;
        dst[j] = -1;
        if (i < npts) {
          const int ly = i / p.win_x, lx = i - ly * p.win_x;
          const int src = extend_src(p, ly, lx, y0, x0);
          if (src >= 0) {
            v[j] = sS[src];
            dst[j] = i;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMaxAll; ++j)
        if (dst[j] >= 0) sS[dst[j]] = v[j];
      __syncthreads();
    }
    for (int c = 0; c < 2; ++c) {
      // cells of colour c: (global row + global column) % 2 == c
      float v[kMaxHalf];
#pragma unroll
      for (int j = 0; j < kMaxHalf; ++j) {
        if ((upd[c] >> j) & 1u) {
          const int i = base[j] + ((c + (odd >> j)) & 1);
          float acc = sG[i];
          if (KT > 0) {
#pragma unroll
            for (int k = 0; k < (KT > 0 ? KT : 1); ++k)
              acc += sW[k * npts + i] * sS[i + off[k]];
          } else {
            for (int k = 0; k < p.K; ++k)
              acc += sW[k * npts + i] * sS[i + s_off[k]];
          }
          const float sv = sS[i];
          v[j] = sv + sR[i] * (acc + sW0[i] * sv);
          if (!p.same_color) sS[i] = v[j];
        }
      }
      if (p.same_color) {
        // some offsets read cells of the colour being updated: the
        // half-sweep reads the state from before it, as the XLA sweep does
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kMaxHalf; ++j)
          if ((upd[c] >> j) & 1u) sS[base[j] + ((c + (odd >> j)) & 1)] = v[j];
      }
      __syncthreads();
    }
  }

  const int oy0 = by * p.tile_y, oy1 = min(p.ny, oy0 + p.tile_y);
  const int ox0 = bx * p.tile_x, ox1 = min(p.nx, ox0 + p.tile_x);
  float* ob = out + b * plane;
  for (int i = tid; i < npts; i += kThreads) {
    const int ly = i / p.win_x, lx = i - ly * p.win_x;
    const int gy = y0 + ly, gx = x0 + lx;   // gx unwrapped: owned once
    if (gy >= oy0 && gy < oy1 && gx >= ox0 && gx < ox1)
      ob[(long long)gy * p.nx + gx] = sS[i];
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

ffi::Error Sor2dImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> S,
                     ffi::Buffer<ffi::F32> W, ffi::Buffer<ffi::F32> W0,
                     ffi::Buffer<ffi::F32> G, ffi::Buffer<ffi::F32> R,
                     ffi::ResultBuffer<ffi::F32> out,
                     ffi::Span<const int32_t> offsets, int32_t sweeps,
                     int32_t tile_y, int32_t tile_x, int32_t halo,
                     int32_t win_y, int32_t win_x, int32_t periodic_x,
                     int32_t extend_y, int32_t bih) {
  auto sd = S.dimensions();
  auto wd = W.dimensions();
  if (sd.size() != 3 || wd.size() != 4 || W0.dimensions().size() != 3 ||
      G.dimensions().size() != 3 || R.dimensions().size() != 3)
    return ffi::Error::InvalidArgument(
        "sor2d: S, w0, g, rel must be (B, ny, nx) and w (K, B, ny, nx)");
  Params p{};
  p.ny = static_cast<int>(sd[1]);
  p.nx = static_cast<int>(sd[2]);
  p.K = static_cast<int>(wd[0]);
  const int B = static_cast<int>(sd[0]);
  if (p.K < 1 || p.K > kMaxK || static_cast<int>(offsets.size()) != 2 * p.K)
    return ffi::Error::InvalidArgument("sor2d: bad offset count");
  p.sweeps = sweeps;
  p.tile_y = tile_y;
  p.tile_x = tile_x;
  p.halo = halo;
  p.win_y = win_y;
  p.win_x = win_x;
  p.periodic_x = periodic_x;
  p.extend_y = extend_y;
  p.bih = bih;
  p.radius = 0;
  p.same_color = 0;
  for (int k = 0; k < p.K; ++k) {
    p.dy[k] = offsets[2 * k];
    p.dx[k] = offsets[2 * k + 1];
    p.radius = std::max(p.radius, std::max(std::abs(p.dy[k]), std::abs(p.dx[k])));
    if (((p.dy[k] + p.dx[k]) & 1) == 0) p.same_color = 1;
  }
  const long long plane = (long long)p.ny * p.nx;
  p.w_kstride = wd[1] * plane;
  p.w_bstride = wd[1] > 1 ? plane : 0;
  p.w0_bstride = W0.dimensions()[0] > 1 ? plane : 0;
  p.g_bstride = G.dimensions()[0] > 1 ? plane : 0;
  p.r_bstride = R.dimensions()[0] > 1 ? plane : 0;

  const int npts = win_y * win_x;
  const size_t smem = sizeof(float) * static_cast<size_t>(p.K + 4) * npts;
  if (win_y > p.ny || (!periodic_x && win_x > p.nx) ||
      (periodic_x && p.nx % 2) || npts > kThreads * kMaxAll ||
      win_y * ((win_x + 1) / 2) > kThreads * kMaxHalf ||
      smem > static_cast<size_t>(kMaxSmem) || tile_y < 1 || tile_x < 1)
    return ffi::Error::InvalidArgument("sor2d: window plan out of range");
  if (sweeps < 1) {
    cudaMemcpyAsync(out->typed_data(), S.typed_data(), sizeof(float) * B * plane,
                    cudaMemcpyDeviceToDevice, stream);
    return ffi::Error::Success();
  }
  auto kernel = p.K == 4 ? sor2d_kernel<4>
              : p.K == 8 ? sor2d_kernel<8>
              : p.K == 12 ? sor2d_kernel<12> : sor2d_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sor2d: ") + cudaGetErrorString(err));
  dim3 grid(ceil_div(p.nx, tile_x), ceil_div(p.ny, tile_y), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      S.typed_data(), W.typed_data(), W0.typed_data(), G.typed_data(),
      R.typed_data(), out->typed_data(), p);
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sor2d: ") + cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(XinvertSor2d, Sor2dImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<ffi::Span<const int32_t>>("offsets")
                                  .Attr<int32_t>("sweeps")
                                  .Attr<int32_t>("tile_y")
                                  .Attr<int32_t>("tile_x")
                                  .Attr<int32_t>("halo")
                                  .Attr<int32_t>("win_y")
                                  .Attr<int32_t>("win_x")
                                  .Attr<int32_t>("periodic_x")
                                  .Attr<int32_t>("extend_y")
                                  .Attr<int32_t>("bih"));
