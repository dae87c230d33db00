// Host emulation of legendre.cu's legendre_synth_mxu (kernel 2): each
// launch runs its blocks one at a time, a block's threads as std::threads
// meeting at a std::barrier.  Usage: synth_mxu IN OUT, IN as run.py writes
// it, OUT the (Mp, P, R, K2) float32 output.
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <thread>
#include <vector>

#include "cuda_runtime.h"

thread_local uint3 threadIdx, blockIdx;
thread_local dim3 gridDim, blockDim;
thread_local float* g_smem;
static std::barrier<>* g_bar;

void __syncthreads() { g_bar->arrive_and_wait(); }
float __shfl_xor_sync(unsigned, float, int) { std::abort(); }

void emu_launch(dim3 grid, unsigned threads, size_t smem, cudaStream_t,
                const std::function<void()>& kernel) {
  std::vector<float> buf(smem / 4 + 64, NAN);   // unwritten reads show
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(threads);
        g_bar = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = {t, 0, 0};
            blockIdx = {x, y, z};
            gridDim = grid;
            blockDim = dim3(threads);
            g_smem = buf.data();
            kernel();
          });
        for (auto& th : ts) th.join();
      }
}

#include "legendre.cu"

template <class T>
static std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (std::fread(v.data(), sizeof(T), n, f) != n) std::abort();
  return v;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = std::fopen(argv[1], "rb");
  const auto h = take<int>(f, 7);   // Mp, L1, K2, R, l_end, fold, spin
  const int Mp = h[0], L1 = h[1], K2 = h[2], R = h[3];
  const auto a = take<float>(f, size_t(Mp) * L1 * K2);
  const auto m = take<int>(f, Mp);
  const auto mp = take<int>(f, Mp);
  const auto x = take<float>(f, R);
  const auto pmm = take<float>(f, size_t(Mp) * R);
  const auto pms = take<int>(f, size_t(Mp) * R);
  std::fclose(f);
  std::vector<float> out(size_t(Mp) * (h[5] ? 2 : 1) * R * K2, NAN);
  const int err = legendre_synth_mxu(
      a.data(), m.data(), h[6] ? mp.data() : nullptr, x.data(), pmm.data(),
      pms.data(), out.data(), Mp, L1, K2, R, h[4], h[5], nullptr);
  if (err != 0) return 1;
  FILE* g = std::fopen(argv[2], "wb");
  std::fwrite(out.data(), 4, out.size(), g);
  std::fclose(g);
  return 0;
}
