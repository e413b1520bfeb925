// AdamW: the whole update of a param list in one pass over memory.
//
// Replaces no TPU kernel.  On the TPU, XLA fused optax's AdamW chain
// (octcubem_tpu/train/optim.py) into one pass by itself; in PyTorch the
// same chain is eleven multi-tensor passes, each reading and writing
// whole lists (train/optim.py, AdamW._foreach_update, kept as the plain
// version for CPU lists).  For each element this kernel reads p, g, mu and
// nu once, computes in fp32 registers and writes p, mu and nu once:
//     g  = g * clip                       (the global-norm clip factor)
//     mu = mu * b1 + (1 - b1) * g
//     nu = nu * b2 + (1 - b2) * (g * g)
//     u  = (mu * (-lr / c1)) / (sqrt(nu / c2) + eps) * s
//     p  = p * (1 - lr * wd * s) + u      (wd 0 where no decay applies)
// each operation rounded where the plain version's passes round it
// (contraction off: __fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn); mu is
// stored in fp32 or bf16 (rounded once, to nearest even), and the update
// uses its fp32 value, as the plain version does.
//
// Bound on an H100 SXM: bytes.  28 B a param in fp32 (p, g, mu, nu read;
// p, mu, nu written; 24 B with bf16 mu) at 3.35 TB/s: 2.78 ms for the
// ViT-L MAE's 332 M params, against ~5 GFLOP at 67 TFLOP/s (0.07 ms).
//
// Design.  One launch takes up to kMaxTensors tensors, their pointers
// and per-tensor metadata passed by value in the kernel's parameters, as
// PyTorch's multi_tensor_apply passes them: nothing is copied from the
// host and nothing allocated, so the launch can be captured into a CUDA
// graph.  Each tensor is cut into chunks of kChunk elements; a grid sized
// to fill the SMs walks the launch's chunks in a grid-stride loop, so
// every block gets the same number of chunks, large tensors and small
// alike.  A chunk that lies whole inside a tensor whose operands are all
// aligned goes as 16-byte loads (float4; 8 bytes of bf16 mu), kIlp of
// them per operand in flight a thread, every load issued before any
// arithmetic; a tensor's last chunk, or a tensor that an operand leaves
// off that alignment (a view into a flat buffer), goes element by
// element.  g takes the read-only path.  The LR, the bias corrections, the
// clip factor and the gate ok are read from device pointers (the count
// lives on the card, and a graph replay advances it there).  Where ok is
// false every block returns before it writes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 2;                       // float4s per operand a thread
constexpr int kChunk = kThreads * 4 * kIlp;   // train/optim.py ADAMW_CHUNK
constexpr int kMaxTensors = 64;               // train/optim.py ADAMW_GROUP

struct Group {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];  // null: a zero gradient
  void* mu[kMaxTensors];
  float* nu[kMaxTensors];
  long long n[kMaxTensors];
  int end[kMaxTensors];         // chunks of tensors 0..i, cumulative
  float scale[kMaxTensors];     // s, the layer scale
  float decay[kMaxTensors];     // wd s (0 where no decay applies)
  int count;
};

struct Scalars {
  float b1, omb1, b2, omb2, eps;
  const float* lr;
  const float* c1;
  const float* c2;
  const float* clip;            // null: no clip
  const bool* ok;               // null: not gated
};

// the constants of one element's update
struct Consts {
  float b1, omb1, b2, omb2, eps, a, c2, clip, s, f;
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Consts& k) {
  g = __fmul_rn(g, k.clip);
  m = __fadd_rn(__fmul_rn(m, k.b1), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(v, k.b2), __fmul_rn(k.omb2, __fmul_rn(g, g)));
  const float d = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.c2)), k.eps);
  const float u = __fmul_rn(__fdiv_rn(__fmul_rn(m, k.a), d), k.s);
  p = __fadd_rn(__fmul_rn(p, k.f), u);
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m,
                                      float4& v, const Consts& k) {
  adam(p.x, g.x, m.x, v.x, k);
  adam(p.y, g.y, m.y, v.y, k);
  adam(p.z, g.z, m.z, v.z, k);
  adam(p.w, g.w, m.w, v.w, k);
}

template <typename T>
struct Mu;

template <>
struct Mu<float> {
  static constexpr uintptr_t kAlign = 16;
  static __device__ __forceinline__ float4 load4(const void* b, long long i) {
    return *reinterpret_cast<const float4*>(static_cast<const float*>(b) + i);
  }
  static __device__ __forceinline__ void store4(void* b, long long i,
                                                const float4& x) {
    *reinterpret_cast<float4*>(static_cast<float*>(b) + i) = x;
  }
  static __device__ __forceinline__ float load(const void* b, long long i) {
    return static_cast<const float*>(b)[i];
  }
  static __device__ __forceinline__ void store(void* b, long long i, float x) {
    static_cast<float*>(b)[i] = x;
  }
};

template <>
struct Mu<__nv_bfloat16> {
  static constexpr uintptr_t kAlign = 8;
  static __device__ __forceinline__ float4 load4(const void* b, long long i) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(b) + i);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ void store4(void* b, long long i,
                                                const float4& x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(b) + i) = raw;
  }
  static __device__ __forceinline__ float load(const void* b, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i]);
  }
  static __device__ __forceinline__ void store(void* b, long long i, float x) {
    static_cast<__nv_bfloat16*>(b)[i] = __float2bfloat16_rn(x);
  }
};

template <typename MuT>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ Group grp,
             const __grid_constant__ Scalars sc) {
  if (sc.ok != nullptr && !*sc.ok) return;
  Consts k;
  k.b1 = sc.b1;
  k.omb1 = sc.omb1;
  k.b2 = sc.b2;
  k.omb2 = sc.omb2;
  k.eps = sc.eps;
  const float lr = *sc.lr;
  k.a = __fdiv_rn(-lr, *sc.c1);
  k.c2 = *sc.c2;
  k.clip = sc.clip != nullptr ? *sc.clip : 1.f;

  const int total = grp.end[grp.count - 1];
  int t = -1, first = 0;
  long long n = 0;
  float* p = nullptr;
  const float* g = nullptr;
  void* mu = nullptr;
  float* nu = nullptr;
  bool vec = false;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    if (t < 0 || c >= grp.end[t]) {  // the chunk opens a later tensor
      do {
        ++t;
      } while (c >= grp.end[t]);
      first = t == 0 ? 0 : grp.end[t - 1];
      p = grp.p[t];
      g = grp.g[t];
      mu = grp.mu[t];
      nu = grp.nu[t];
      n = grp.n[t];
      k.s = grp.scale[t];
      k.f = __fsub_rn(1.f, __fmul_rn(lr, grp.decay[t]));
      const uintptr_t a16 = reinterpret_cast<uintptr_t>(p) |
                            reinterpret_cast<uintptr_t>(g) |
                            reinterpret_cast<uintptr_t>(nu);
      vec = (a16 & 15) == 0 &&
            (reinterpret_cast<uintptr_t>(mu) & (Mu<MuT>::kAlign - 1)) == 0;
    }
    const long long e0 = static_cast<long long>(c - first) * kChunk;
    if (vec && e0 + kChunk <= n) {
      float4 pv[kIlp], gv[kIlp], mv[kIlp], vv[kIlp];
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const long long e = e0 + 4LL * (i * kThreads + threadIdx.x);
        pv[i] = *reinterpret_cast<const float4*>(p + e);
        gv[i] = g != nullptr ? __ldg(reinterpret_cast<const float4*>(g + e))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        mv[i] = Mu<MuT>::load4(mu, e);
        vv[i] = *reinterpret_cast<const float4*>(nu + e);
      }
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const long long e = e0 + 4LL * (i * kThreads + threadIdx.x);
        adam4(pv[i], gv[i], mv[i], vv[i], k);
        *reinterpret_cast<float4*>(p + e) = pv[i];
        Mu<MuT>::store4(mu, e, mv[i]);
        *reinterpret_cast<float4*>(nu + e) = vv[i];
      }
    } else {
      const long long stop = e0 + kChunk < n ? e0 + kChunk : n;
      for (long long e = e0 + threadIdx.x; e < stop; e += kThreads) {
        float pe = p[e], me = Mu<MuT>::load(mu, e), ve = nu[e];
        adam(pe, g != nullptr ? __ldg(g + e) : 0.f, me, ve, k);
        p[e] = pe;
        Mu<MuT>::store(mu, e, me);
        nu[e] = ve;
      }
    }
  }
}

// blocks of kThreads one SM holds at once for the kernel, per device
template <typename MuT>
int grid_cap() {
  static int cap[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cap[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, adamw_kernel<MuT>, kThreads, 0) != cudaSuccess)
      return 0;
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

}  // namespace

// One launch over `count` tensors (1..kMaxTensors, none empty), in the
// order train/optim.py's adamw_launches groups them.  Host arrays, read
// before this returns: ptrs (p, g, mu, nu a tensor; g 0 for a zero
// gradient), sizes (elements), ends (cumulative chunks of kChunk), scale
// and decay (see Group); hyper = b1, 1 - b1, b2, 1 - b2, eps.  Device
// pointers: lr, c1, c2 (fp32); clip (fp32) and ok (bool), or null.
extern "C" int octcube_adamw(const long long* ptrs, const long long* sizes,
                             const int* ends, const float* scale,
                             const float* decay, int count, int mu_bf16,
                             const float* hyper, const void* lr,
                             const void* c1, const void* c2,
                             const void* clip, const void* ok, void* stream) {
  if (count < 1 || count > kMaxTensors) return cudaErrorInvalidValue;
  if (lr == nullptr || c1 == nullptr || c2 == nullptr)
    return cudaErrorInvalidValue;
  Group grp;
  int prev = 0;
  for (int i = 0; i < count; ++i) {
    const long long chunks = (sizes[i] + kChunk - 1) / kChunk;
    if (sizes[i] < 1 || ends[i] - prev != chunks) return cudaErrorInvalidValue;
    prev = ends[i];
    grp.p[i] = reinterpret_cast<float*>(ptrs[4 * i]);
    grp.g[i] = reinterpret_cast<const float*>(ptrs[4 * i + 1]);
    grp.mu[i] = reinterpret_cast<void*>(ptrs[4 * i + 2]);
    grp.nu[i] = reinterpret_cast<float*>(ptrs[4 * i + 3]);
    grp.n[i] = sizes[i];
    grp.end[i] = ends[i];
    grp.scale[i] = scale[i];
    grp.decay[i] = decay[i];
  }
  grp.count = count;
  Scalars sc;
  sc.b1 = hyper[0];
  sc.omb1 = hyper[1];
  sc.b2 = hyper[2];
  sc.omb2 = hyper[3];
  sc.eps = hyper[4];
  sc.lr = static_cast<const float*>(lr);
  sc.c1 = static_cast<const float*>(c1);
  sc.c2 = static_cast<const float*>(c2);
  sc.clip = static_cast<const float*>(clip);
  sc.ok = static_cast<const bool*>(ok);
  const int cap = mu_bf16 ? grid_cap<__nv_bfloat16>() : grid_cap<float>();
  if (cap < 1) {
    const cudaError_t err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  }
  const int grid = prev < cap ? prev : cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mu_bf16)
    adamw_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(grp, sc);
  else
    adamw_kernel<float><<<grid, kThreads, 0, st>>>(grp, sc);
  return cudaGetLastError();
}

extern "C" const char* octcube_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
