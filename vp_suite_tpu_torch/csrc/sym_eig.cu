// E1: batched eigenvalues and eigenvectors of symmetric f32 matrices for Hopper (sm_90a), by cyclic
// two-sided Jacobi.
//
// Replaces no Pallas kernel. The JAX package's differentiable FVD (measure/fvd/fvd.py,
// wasserstein2_jax) takes the eigenvalues of m = a a^T, a = c_p^T c_t [b, b] (b the FVD batch), from
// jnp.linalg.eigh, which XLA lowers inside the jitted train and eval steps. The port's counterpart,
// torch.linalg.eigh, reaches cuSOLVER and then reads its `info` back to the host, which a CUDA-graph
// capture forbids; this kernel reads nothing back, so FVD as a loss runs inside the captured steps.
//
// Function: for each matrix m [n, n] of the batch (its lower triangle read, as eigh reads it), the
// ascending eigenvalues w [n] and the eigenvectors v [n, n] (column j belongs to w[j]), m = v diag(w)
// v^T. Any n >= 1; n = 1 gives w = m, v = 1.
//
// Algorithm (Golub & Van Loan, the cyclic Jacobi method with a parallel ordering):
// - A = m (padded with a zero row and column to an even n2 where n is odd: the pad stays decoupled
//   and is left out of the result), V = I.
// - A sweep is n2 - 1 rounds of the round-robin tournament on n2 indices: index 0 stays, the others
//   turn by one place a round, and pair i of round r is (pos(i), pos(n2 - 1 - i)), so each round
//   holds n2 / 2 disjoint pairs and a sweep meets every pair once.
// - In a round, each pair (p, q) takes the rotation that zeroes A[p, q]: tau = (A[q,q] - A[p,p]) /
//   (2 A[p,q]), t = sign(tau) / (|tau| + hypot(1, tau)), c = 1 / sqrt(1 + t^2), s = t c (c = 1, s = 0
//   where A[p,q] is 0). The rotations are disjoint, so the round applies them all at once: each 2x2
//   block of A at the rows of pair a and the columns of pair b becomes R_a^T X R_b, computed once
//   for a < b and stored with its transpose (A stays exactly symmetric); the diagonal block of a pair
//   becomes diag(A[p,p] - t A[p,q], A[q,q] + t A[p,q]) with an exact zero off its diagonal; V's
//   columns of each pair rotate by R. A rotation of (x, y) is applied as x - s (y + u x), y + s (x -
//   u y) with u = s / (1 + c) (Numerical Recipes' form: a small rotation adds a small correction, so
//   the many small rotations of the last sweeps do not each round V by an ulp, which c x - s y does
//   and which V's orthogonality then shows). An off-diagonal entry is only ever computed
//   from off-diagonal entries, so the off-diagonal part shrinks quadratically with no floor set by
//   the diagonal's size.
// - Convergence, tested on the device before each sweep: the off-diagonal Frobenius norm at most
//   FLT_EPSILON times m's Frobenius norm (which the rotations keep), or MAX_SWEEPS sweeps done. A zero
//   matrix (the FVD of one video: centred features are 0) stops before the first sweep.
// - The eigenvalues are A's diagonal, sorted ascending by rank (ties, and NaNs last, by index), and
//   V's columns follow them.
// Every sum is taken in a fixed order (per-thread strides, warp butterflies, then the warps in
// order), so a launch is bit-reproducible: a graph replay gives the eager call's bits.
//
// Layout: m [batch, n, n], w [batch, n], v [batch, n, n] row-major f32, contiguous; one block per
// matrix. A and V live in shared memory where both fit (2 n2^2 f32: n up to about 168 on an H100,
// under the opt-in limit set at each launch), else in `scratch` [batch, 2, n2, n2] f32 (the caller
// always allocates it; it stays in L2 at FVD's sizes). The kernel allocates nothing and reads nothing
// back.
//
// Bound: operations. A sweep applies n2 - 1 rounds of n2^2 / 4 two-by-two rotations of A (half of
// them, with the transposes stored) and of V, some 9 n^3 flops for the few sweeps it takes (the
// operator's FLOP formula); the bytes are m read once and w, v written once (2 n^2 f32). At FVD's b
// = 32 both bounds are a few nanoseconds: what sets this kernel's time is the chain of ~250 dependent
// rounds, each two block barriers apart, on one SM. A simple kernel first: its time is on record in
// PERF.md; batching chunks, or a one-sided (Hestenes) form on the features, are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_SWEEPS = 30;
constexpr int MAX_THREADS = 1024;
constexpr float EPS = 1.1920928955078125e-07f;  // FLT_EPSILON

// The sum of `x` over the block, the same value in every thread, in a fixed order. `red` holds one
// float per warp; the block synchronises before returning, so `red` may be reused.
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
  for (int k = 0; k < int(blockDim.x / 32); ++k) total += red[k];
  __syncthreads();
  return total;
}

// Index at place j of round r of the round-robin tournament on n2 indices.
__device__ __forceinline__ int tour(int j, int r, int n2) {
  return j == 0 ? 0 : 1 + (j - 1 + r) % (n2 - 1);
}

// NaN-last ascending order, ties by index.
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  const bool nx = isnan(x), ny = isnan(y);
  if (nx || ny) return nx == ny ? i < j : ny;
  return x < y || (x == y && i < j);
}

// Dynamic shared memory: red [32], the round's rotations (s, u, t) [3 * n2 / 2] (ranks [n2] at the
// end), then A and V [n2 * n2] each when SHARED.
__host__ __device__ inline size_t small_floats(int n2) { return 32 + 2 * size_t(n2); }

template <bool SHARED>
__global__ void __launch_bounds__(MAX_THREADS)
sym_eig_kernel(const float* __restrict__ m, float* __restrict__ w, float* __restrict__ v_out,
               float* __restrict__ scratch, int n, int n2) {
  extern __shared__ float smem[];
  float* red = smem;
  float* rot = smem + 32;
  const int half = n2 / 2;
  const size_t nn = size_t(n2) * n2;
  float* A = SHARED ? smem + small_floats(n2) : scratch + 2 * nn * blockIdx.x;
  float* V = A + nn;
  const float* mb = m + size_t(blockIdx.x) * n * n;
  const int tid = threadIdx.x, nt = blockDim.x;

  // A = the symmetric matrix of m's lower triangle, padded; V = I. The squared norm on the way.
  float sq = 0.f;
  for (int idx = tid; idx < n2 * n2; idx += nt) {
    const int i = idx / n2, j = idx % n2;
    const float a = (i < n && j < n) ? mb[size_t(i >= j ? i : j) * n + (i >= j ? j : i)] : 0.f;
    A[idx] = a;
    V[idx] = i == j ? 1.f : 0.f;
    sq += a * a;
  }
  const float tol = EPS * EPS * block_sum(sq, red);   // (eps ||m||_F)^2

  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    float off = 0.f;
    for (int idx = tid; idx < n2 * n2; idx += nt)
      if (idx / n2 != idx % n2) off += A[idx] * A[idx];
    if (!(block_sum(off, red) > tol)) break;          // the same decision in every thread

    for (int r = 0; r < n2 - 1; ++r) {
      for (int i = tid; i < half; i += nt) {
        const int p = tour(i, r, n2), q = tour(n2 - 1 - i, r, n2);
        const float apq = A[p * n2 + q];
        float s = 0.f, u = 0.f, t = 0.f;
        if (apq != 0.f) {
          const float tau = (A[q * n2 + q] - A[p * n2 + p]) / (2.f * apq);
          t = (tau >= 0.f ? 1.f : -1.f) / (fabsf(tau) + hypotf(1.f, tau));
          const float c = 1.f / sqrtf(1.f + t * t);
          s = t * c;
          u = s / (1.f + c);
        }
        rot[i] = s;
        rot[half + i] = u;
        rot[2 * half + i] = t;
      }
      __syncthreads();
      // A: the blocks (a, b), a <= b, with their transposes
      for (int idx = tid; idx < half * half; idx += nt) {
        const int a = idx / half, b = idx % half;
        if (a > b) continue;
        const int pa = tour(a, r, n2), qa = tour(n2 - 1 - a, r, n2);
        const float sa = rot[a], ua = rot[half + a];
        if (a == b) {
          const float apq = A[pa * n2 + qa], t = rot[2 * half + a];
          A[pa * n2 + pa] -= t * apq;
          A[qa * n2 + qa] += t * apq;
          A[pa * n2 + qa] = A[qa * n2 + pa] = 0.f;
          continue;
        }
        const int pb = tour(b, r, n2), qb = tour(n2 - 1 - b, r, n2);
        const float sb = rot[b], ub = rot[half + b];
        const float x00 = A[pa * n2 + pb], x01 = A[pa * n2 + qb];
        const float x10 = A[qa * n2 + pb], x11 = A[qa * n2 + qb];
        const float r00 = x00 - sa * (x10 + ua * x00), r01 = x01 - sa * (x11 + ua * x01);
        const float r10 = x10 + sa * (x00 - ua * x10), r11 = x11 + sa * (x01 - ua * x11);
        const float y00 = r00 - sb * (r01 + ub * r00), y01 = r01 + sb * (r00 - ub * r01);
        const float y10 = r10 - sb * (r11 + ub * r10), y11 = r11 + sb * (r10 - ub * r11);
        A[pa * n2 + pb] = A[pb * n2 + pa] = y00;
        A[pa * n2 + qb] = A[qb * n2 + pa] = y01;
        A[qa * n2 + pb] = A[pb * n2 + qa] = y10;
        A[qa * n2 + qb] = A[qb * n2 + qa] = y11;
      }
      // V = V J: the columns of each pair
      for (int idx = tid; idx < n2 * half; idx += nt) {
        const int k = idx / half, b = idx % half;
        const int pb = tour(b, r, n2), qb = tour(n2 - 1 - b, r, n2);
        const float sb = rot[b], ub = rot[half + b];
        const float vp = V[k * n2 + pb], vq = V[k * n2 + qb];
        V[k * n2 + pb] = vp - sb * (vq + ub * vp);
        V[k * n2 + qb] = vq + sb * (vp - ub * vq);
      }
      __syncthreads();
    }
  }

  // sort: each eigenvalue's rank, then w and v's columns by rank
  int* rank = reinterpret_cast<int*>(rot);
  for (int i = tid; i < n; i += nt) {
    const float di = A[i * n2 + i];
    int k = 0;
    for (int j = 0; j < n; ++j) k += before(A[j * n2 + j], j, di, i);
    rank[i] = k;
  }
  __syncthreads();
  float* wb = w + size_t(blockIdx.x) * n;
  float* vb = v_out + size_t(blockIdx.x) * n * n;
  for (int i = tid; i < n; i += nt) wb[rank[i]] = A[i * n2 + i];
  for (int idx = tid; idx < n * n; idx += nt) {
    const int k = idx / n, i = idx % n;
    vb[size_t(k) * n + rank[i]] = V[k * n2 + i];
  }
}

int threads_for(int n2) {
  const int work = n2 * (n2 / 2);
  const int t = (work + 31) / 32 * 32;
  return t < 64 ? 64 : (t > MAX_THREADS ? MAX_THREADS : t);
}

int finish(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so later launches do not report it
  return int(err);
}

}  // namespace

extern "C" {

// The eigendecomposition of `batch` symmetric matrices m [batch, n, n] (f32, lower triangle read)
// on `stream`: w [batch, n] ascending, v [batch, n, n] (columns the eigenvectors); scratch [batch,
// 2, n2, n2] f32 with n2 = n rounded up to even, used where A and V do not fit in shared memory. All
// contiguous. Returns a cudaError_t (0 on success).
int vp_sym_eig(const float* m, float* w, float* v, float* scratch, int batch, int n, void* stream) {
  if (batch < 1 || n < 1 || n > 46340) return finish(cudaErrorInvalidValue);
  const int n2 = n + (n & 1);
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return finish(err);
  const size_t small = small_floats(n2) * sizeof(float);
  const size_t whole = small + 2 * size_t(n2) * n2 * sizeof(float);
  const bool shared = whole <= size_t(smem_max);
  const size_t bytes = shared ? whole : small;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (shared) {
    err = cudaFuncSetAttribute(sym_eig_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
    if (err != cudaSuccess) return finish(err);
    sym_eig_kernel<true><<<batch, threads_for(n2), bytes, st>>>(m, w, v, scratch, n, n2);
  } else {
    err = cudaFuncSetAttribute(sym_eig_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
    if (err != cudaSuccess) return finish(err);
    sym_eig_kernel<false><<<batch, threads_for(n2), bytes, st>>>(m, w, v, scratch, n, n2);
  }
  return finish(cudaGetLastError());
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
