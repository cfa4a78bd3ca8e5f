// Native fusion planner.
//
// Reference: the fusion scan inside Controller::ComputeResponseList +
// FusionBufferManager (horovod/common/controller.cc,
// fusion_buffer_manager.cc).  There the planner runs on the C++
// background thread every cycle; here it runs when a step is built.
//
// Contract (mirrors ops/fusion.py:plan_buckets_py exactly; property-
// tested for equivalence in tests/test_torch_port_native.py):
//   - greedy, order-preserving bin packing
//   - a bucket closes when adding the next tensor would exceed
//     `threshold` bytes (oversized tensors get singleton buckets)
//
// Built with the rest of src/ by native/build.py.

#include <cstdint>

extern "C" {

// Two-phase decision per bucket from the alpha-beta cost model (mirrors
// ops/fusion.py:plan_two_phase_flags exactly; equivalence tested in
// tests/test_torch_port_native.py): a bucket decomposes into
// reduce-scatter + all-gather when its payload clears the crossover
// alpha_us * beta_gbps * 1e3 * world_size bytes — i.e. the per-hop
// shard transfer time bytes/(n*beta) is at least the extra phase launch
// latency alpha.  Writes flags[i] in {0, 1}; returns the number of
// decomposed buckets, or -1 on invalid input.
int64_t hvd_tpu_plan_two_phase(const int64_t* bucket_bytes,
                               int64_t n_buckets, int64_t world_size,
                               double alpha_us, double beta_gbps,
                               int8_t* flags) {
  if (n_buckets < 0 || (n_buckets > 0 && (!bucket_bytes || !flags)) ||
      alpha_us < 0 || beta_gbps <= 0) {
    return -1;
  }
  int64_t decomposed = 0;
  if (world_size <= 1) {
    for (int64_t i = 0; i < n_buckets; ++i) flags[i] = 0;
    return 0;
  }
  const double crossover_d =
      alpha_us * beta_gbps * 1e3 * static_cast<double>(world_size);
  // Truncate exactly like the Python planner's int() — ranks that fell
  // back to Python (native build failure) must still compute identical
  // flags at the crossover boundary.  Past int64 range nothing can
  // clear the bar.
  const bool unreachable = crossover_d >= 9.2e18;
  const int64_t crossover =
      unreachable ? 0 : static_cast<int64_t>(crossover_d);
  for (int64_t i = 0; i < n_buckets; ++i) {
    if (bucket_bytes[i] < 0) return -1;
    flags[i] = (!unreachable && bucket_bytes[i] >= crossover) ? 1 : 0;
    decomposed += flags[i];
  }
  return decomposed;
}

// Two-tier schedule choice per bucket (mirrors
// topo/schedule.py:choose_algo exactly; equivalence property-tested in
// tests/test_torch_port_native.py).  For a mesh of `pods` pods
// of `chips` chips with per-tier alpha/beta (ICI intra-pod, DCN
// inter-pod), writes algos[i] in {0 = flat, 1 = two_phase,
// 2 = hierarchical}:
//   flat(b)  = pods > 1 ? 2(n-1)(a_ici + (b/n)/(b_dcn*1e3))
//                       : 2(n-1)(a_ici + (b/n)/(b_ici*1e3))
//   hier(b)  = 2(C-1)(a_ici + (b/C)/(b_ici*1e3))
//            + 2(P-1)((b/C)/P/(b_dcn*1e3) + a_dcn)
//   hierarchical when hier < flat on a genuinely two-tier mesh;
//   otherwise two_phase when b clears the flat-family crossover
//   a_ici * beta_eff * 1e3 * n (beta_eff = DCN beta on multi-pod
//   meshes), else flat.
// Returns the number of hierarchical buckets, or -1 on invalid input.
int64_t hvd_tpu_plan_hierarchical(const int64_t* bucket_bytes,
                                  int64_t n_buckets, int64_t pods,
                                  int64_t chips, double a_ici,
                                  double b_ici, double a_dcn,
                                  double b_dcn, int8_t* algos) {
  if (n_buckets < 0 || (n_buckets > 0 && (!bucket_bytes || !algos)) ||
      pods < 1 || chips < 1 || a_ici < 0 || a_dcn < 0 || b_ici <= 0 ||
      b_dcn <= 0) {
    return -1;
  }
  const int64_t n = pods * chips;
  int64_t hier_count = 0;
  const bool two_tier = pods > 1 && chips > 1;
  const double beta_eff = pods > 1 ? b_dcn : b_ici;
  const double crossover_d = a_ici * beta_eff * 1e3 * static_cast<double>(n);
  const bool unreachable = crossover_d >= 9.2e18;
  for (int64_t i = 0; i < n_buckets; ++i) {
    if (bucket_bytes[i] < 0) return -1;
    const double b = static_cast<double>(bucket_bytes[i]);
    if (n <= 1) {
      algos[i] = 0;
      continue;
    }
    if (two_tier) {
      // Same operation order as the Python model (costmodel.py), so
      // both sides truncate/compare identically at the boundary.
      const double flat =
          2.0 * (n - 1) * (a_ici + (b / n) / (b_dcn * 1e3));
      const double hier =
          2.0 * (chips - 1) * (a_ici + (b / chips) / (b_ici * 1e3)) +
          2.0 * (pods - 1) * (a_dcn + ((b / chips) / pods) / (b_dcn * 1e3));
      if (hier < flat) {
        algos[i] = 2;
        ++hier_count;
        continue;
      }
    }
    algos[i] =
        (!unreachable &&
         bucket_bytes[i] >= static_cast<int64_t>(crossover_d)) ? 1 : 0;
  }
  return hier_count;
}

// Writes bucket_ids[i] = bucket index of tensor i (buckets are
// consecutive, starting at 0). Returns the number of buckets, or -1 on
// invalid input.
int64_t hvd_tpu_plan_buckets(const int64_t* sizes_bytes, int64_t n,
                             int64_t threshold, int32_t* bucket_ids) {
  if (n < 0 || threshold < 0 || (n > 0 && (!sizes_bytes || !bucket_ids))) {
    return -1;
  }
  int64_t bucket = 0;
  int64_t current_bytes = 0;
  bool current_empty = true;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t sz = sizes_bytes[i];
    if (sz < 0) return -1;
    if (!current_empty && current_bytes + sz > threshold) {
      ++bucket;
      current_bytes = 0;
    }
    bucket_ids[i] = static_cast<int32_t>(bucket);
    current_bytes += sz;
    current_empty = false;
  }
  return n == 0 ? 0 : bucket + 1;
}

}  // extern "C"
