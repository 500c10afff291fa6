// Native beam Viterbi decoder over mapped loglikes (the runtime-native
// replacement for the reference's csrc/decoder.cc MappedLatticeFasterRecognizer
// built on kaldi's LatticeFasterDecoderTpl). TPU computes the acoustic
// loglikes; this decoder consumes them on the host.
//
// Graph representation: flat arc arrays (src, dst, ilabel=pdf+1 (0=eps),
// olabel=word, weight=-logprob) in CSR order by src, plus final costs.
// Epsilon arcs are expanded each frame (cost-ordered relaxation).
//
// C ABI (ctypes):
//   satpu_decode(...) -> best path words + per-frame pdf alignment + cost.
//
// Build: g++ -O3 -march=native -shared -fPIC decoder.cc -o libsatpu_decoder.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Graph {
  int32_t num_states;
  const int32_t* row_start;  // [num_states + 1] CSR offsets into arcs
  const int32_t* dst;
  const int32_t* ilabel;
  const int32_t* olabel;
  const float* weight;
  const float* final_cost;  // [num_states]
  int32_t start;
};

struct BackPtr {
  int32_t prev;
  int32_t olabel;
  int32_t pdf;  // -1 for epsilon
};

// Relax epsilon arcs until fixpoint (cost-ordered). tokens: cost per state
// (kInf = inactive), bp: backpointer index per state.
void EpsilonClosure(const Graph& g, std::vector<float>* cost,
                    std::vector<int32_t>* bp, std::vector<BackPtr>* bps,
                    const std::vector<int32_t>& active_in,
                    std::vector<int32_t>* active_out) {
  using QE = std::pair<float, int32_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> q;
  for (int32_t s : active_in) q.push({(*cost)[s], s});
  std::vector<uint8_t> seen(g.num_states, 0);
  active_out->clear();
  while (!q.empty()) {
    auto [c, s] = q.top();
    q.pop();
    if (c > (*cost)[s]) continue;
    if (!seen[s]) {
      seen[s] = 1;
      active_out->push_back(s);
    }
    for (int32_t a = g.row_start[s]; a < g.row_start[s + 1]; ++a) {
      if (g.ilabel[a] != 0) continue;
      float nc = c + g.weight[a];
      int32_t d = g.dst[a];
      if (nc < (*cost)[d]) {
        (*cost)[d] = nc;
        bps->push_back({(*bp)[s], g.olabel[a], -1});
        (*bp)[d] = (int32_t)bps->size() - 1;
        q.push({nc, d});
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success. Outputs:
//   out_words [max_out] / out_nwords, out_align [T] / out_nalign, out_cost.
int satpu_decode(int32_t num_states, const int32_t* row_start,
                 const int32_t* dst, const int32_t* ilabel,
                 const int32_t* olabel, const float* weight,
                 const float* final_cost, int32_t start_state, int32_t T,
                 int32_t P, const float* loglikes, float acoustic_scale,
                 float beam, int32_t max_active, int32_t* out_words,
                 int32_t max_out, int32_t* out_nwords, int32_t* out_align,
                 int32_t* out_nalign, float* out_cost) {
  Graph g{num_states, row_start, dst, ilabel, olabel, weight, final_cost,
          start_state};

  std::vector<BackPtr> bps;
  bps.reserve((size_t)T * 64);
  bps.push_back({-1, 0, -1});

  std::vector<float> cost(num_states, kInf), next_cost(num_states, kInf);
  std::vector<int32_t> bp(num_states, 0), next_bp(num_states, 0);
  std::vector<int32_t> active, next_active, closure_active;
  cost[start_state] = 0.0f;
  active.push_back(start_state);
  EpsilonClosure(g, &cost, &bp, &bps, active, &closure_active);
  active = closure_active;

  std::vector<float> costs_buf;
  for (int32_t t = 0; t < T; ++t) {
    const float* ll = loglikes + (size_t)t * P;
    next_active.clear();
    float best = kInf;
    for (int32_t s : active) {
      float c = cost[s];
      int32_t b = bp[s];
      for (int32_t a = g.row_start[s]; a < g.row_start[s + 1]; ++a) {
        int32_t il = g.ilabel[a];
        if (il == 0) continue;
        float nc = c + g.weight[a] - acoustic_scale * ll[il - 1];
        int32_t d = g.dst[a];
        if (nc < next_cost[d]) {
          if (next_cost[d] == kInf) next_active.push_back(d);
          next_cost[d] = nc;
          bps.push_back({b, g.olabel[a], il - 1});
          next_bp[d] = (int32_t)bps.size() - 1;
          if (nc < best) best = nc;
        }
      }
    }
    // beam pruning
    float cutoff = best + beam;
    std::vector<int32_t> pruned;
    pruned.reserve(next_active.size());
    for (int32_t s : next_active) {
      if (next_cost[s] <= cutoff)
        pruned.push_back(s);
      else
        next_cost[s] = kInf;
    }
    // max-active pruning
    if ((int32_t)pruned.size() > max_active) {
      costs_buf.clear();
      for (int32_t s : pruned) costs_buf.push_back(next_cost[s]);
      std::nth_element(costs_buf.begin(), costs_buf.begin() + max_active - 1,
                       costs_buf.end());
      float thr = costs_buf[max_active - 1];
      std::vector<int32_t> keep;
      keep.reserve(max_active);
      for (int32_t s : pruned) {
        if (next_cost[s] <= thr && (int32_t)keep.size() < max_active)
          keep.push_back(s);
        else if (next_cost[s] > thr)
          next_cost[s] = kInf;
      }
      pruned.swap(keep);
    }
    // epsilon closure on the surviving tokens
    EpsilonClosure(g, &next_cost, &next_bp, &bps, pruned, &closure_active);
    // swap frames
    for (int32_t s : active) {
      cost[s] = kInf;
    }
    std::swap(cost, next_cost);
    std::swap(bp, next_bp);
    active = closure_active;
    if (active.empty()) break;
  }

  // pick best final token
  float best_total = kInf;
  int32_t best_bp = -1;
  for (int32_t s : active) {
    float fc = final_cost[s];
    float total = cost[s] + (std::isinf(fc) ? 0.0f : fc);
    bool is_final = !std::isinf(fc);
    if (is_final && total < best_total) {
      best_total = total;
      best_bp = bp[s];
    }
  }
  if (best_bp < 0) {  // no final state reached: fall back to best live token
    for (int32_t s : active) {
      if (cost[s] < best_total) {
        best_total = cost[s];
        best_bp = bp[s];
      }
    }
  }
  if (best_bp < 0) {
    *out_nwords = 0;
    *out_nalign = 0;
    *out_cost = kInf;
    return 1;
  }

  std::vector<int32_t> words, align;
  for (int32_t b = best_bp; b > 0; b = bps[b].prev) {
    if (bps[b].olabel != 0) words.push_back(bps[b].olabel);
    if (bps[b].pdf >= 0) align.push_back(bps[b].pdf);
  }
  std::reverse(words.begin(), words.end());
  std::reverse(align.begin(), align.end());
  int32_t nw = std::min<int32_t>((int32_t)words.size(), max_out);
  std::memcpy(out_words, words.data(), sizeof(int32_t) * nw);
  *out_nwords = nw;
  int32_t na = std::min<int32_t>((int32_t)align.size(), T);
  std::memcpy(out_align, align.data(), sizeof(int32_t) * na);
  *out_nalign = na;
  *out_cost = best_total;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Lattice generation (the reference's MappedLatticeFasterRecognizer
// lattice path, csrc/decoder.cc:96-153, redesigned):
// time-synchronous token passing that records, per destination token, every
// incoming arc within lattice_beam of that token's best cost, followed by a
// global forward+backward prune to best_total + lattice_beam. Emits a DAG of
// (time, state) nodes with per-arc word labels and separate graph/acoustic
// costs so word-level LM rescoring can subtract/add LM scores downstream.
// ---------------------------------------------------------------------------

namespace {

struct LatArc {
  int32_t from, to;     // node ids
  int32_t word;         // olabel (0 = eps)
  int32_t pdf;          // -1 for epsilon arcs
  float graph_cost;
  float acoustic_cost;
};

}  // namespace

extern "C" {

// Returns 0 ok, 1 no path, 2 capacity exceeded (re-call with bigger caps).
// Nodes are emitted with times (frame index); node 0 is the start node.
// out_final_cost[n] = final cost of node n (inf when not final).
int satpu_decode_lattice(
    int32_t num_states, const int32_t* row_start, const int32_t* dst,
    const int32_t* ilabel, const int32_t* olabel, const float* weight,
    const float* final_cost, int32_t start_state, int32_t T, int32_t P,
    const float* loglikes, float acoustic_scale, float beam,
    float lattice_beam, int32_t max_active,
    // outputs
    int32_t* out_arc_from, int32_t* out_arc_to, int32_t* out_arc_word,
    int32_t* out_arc_pdf, float* out_arc_graph, float* out_arc_acoustic,
    int32_t arc_cap, int32_t* out_narcs,
    int32_t* out_node_time, float* out_node_final, int32_t node_cap,
    int32_t* out_nnodes) {
  Graph g{num_states, row_start, dst, ilabel, olabel, weight, final_cost,
          start_state};

  // node bookkeeping: nodes created lazily per (frame, state)
  std::vector<int32_t> node_of(num_states, -1), next_node_of(num_states, -1);
  std::vector<int32_t> node_time;
  std::vector<LatArc> arcs;
  arcs.reserve(1 << 20);

  std::vector<float> cost(num_states, kInf), next_cost(num_states, kInf);
  std::vector<int32_t> active, next_active;

  auto new_node = [&](int32_t t) {
    node_time.push_back(t);
    return (int32_t)node_time.size() - 1;
  };

  cost[start_state] = 0.0f;
  node_of[start_state] = new_node(0);
  active.push_back(start_state);

  // epsilon closure at t=0 recording arcs
  {
    using QE = std::pair<float, int32_t>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> q;
    q.push({0.0f, start_state});
    while (!q.empty()) {
      auto [c, s] = q.top();
      q.pop();
      if (c > cost[s]) continue;
      for (int32_t a = g.row_start[s]; a < g.row_start[s + 1]; ++a) {
        if (g.ilabel[a] != 0) continue;
        int32_t d = g.dst[a];
        float nc = c + g.weight[a];
        if (nc < cost[d] + lattice_beam) {
          if (node_of[d] < 0) {
            node_of[d] = new_node(0);
            active.push_back(d);
          }
          arcs.push_back({node_of[s], node_of[d], g.olabel[a], -1, g.weight[a], 0.0f});
          if (nc < cost[d]) {
            cost[d] = nc;
            q.push({nc, d});
          }
        }
      }
    }
  }

  std::vector<float> costs_buf;
  for (int32_t t = 0; t < T; ++t) {
    const float* ll = loglikes + (size_t)t * P;
    next_active.clear();
    float best = kInf;
    // pass 1: Viterbi next costs (emitting arcs)
    for (int32_t s : active) {
      float c = cost[s];
      for (int32_t a = g.row_start[s]; a < g.row_start[s + 1]; ++a) {
        int32_t il = g.ilabel[a];
        if (il == 0) continue;
        float nc = c + g.weight[a] - acoustic_scale * ll[il - 1];
        int32_t d = g.dst[a];
        if (nc < next_cost[d]) {
          if (next_cost[d] == kInf) next_active.push_back(d);
          next_cost[d] = nc;
          if (nc < best) best = nc;
        }
      }
    }
    // beam + max-active pruning of destinations
    float cutoff = best + beam;
    if ((int32_t)next_active.size() > max_active) {
      costs_buf.clear();
      for (int32_t s : next_active) costs_buf.push_back(next_cost[s]);
      std::nth_element(costs_buf.begin(), costs_buf.begin() + max_active - 1,
                       costs_buf.end());
      cutoff = std::min(cutoff, costs_buf[max_active - 1]);
    }
    std::vector<int32_t> kept;
    kept.reserve(next_active.size());
    for (int32_t s : next_active) {
      if (next_cost[s] <= cutoff)
        kept.push_back(s);
      else
        next_cost[s] = kInf;
    }
    // pass 2: record arcs into surviving destinations within lattice_beam
    for (int32_t s : active) {
      float c = cost[s];
      int32_t from = node_of[s];
      for (int32_t a = g.row_start[s]; a < g.row_start[s + 1]; ++a) {
        int32_t il = g.ilabel[a];
        if (il == 0) continue;
        int32_t d = g.dst[a];
        if (next_cost[d] == kInf) continue;
        float ac = -acoustic_scale * ll[il - 1];
        float nc = c + g.weight[a] + ac;
        if (nc <= next_cost[d] + lattice_beam) {
          if (next_node_of[d] < 0) next_node_of[d] = new_node(t + 1);
          arcs.push_back({from, next_node_of[d], g.olabel[a], il - 1,
                          g.weight[a], ac});
        }
      }
    }
    // epsilon closure over survivors (same frame t+1), recording arcs
    {
      using QE = std::pair<float, int32_t>;
      std::priority_queue<QE, std::vector<QE>, std::greater<QE>> q;
      for (int32_t s : kept) q.push({next_cost[s], s});
      while (!q.empty()) {
        auto [c, s] = q.top();
        q.pop();
        if (c > next_cost[s]) continue;
        for (int32_t a = g.row_start[s]; a < g.row_start[s + 1]; ++a) {
          if (g.ilabel[a] != 0) continue;
          int32_t d = g.dst[a];
          float nc = c + g.weight[a];
          float dc = (next_cost[d] == kInf) ? kInf : next_cost[d];
          if (nc <= dc + lattice_beam) {
            if (next_node_of[d] < 0) {
              next_node_of[d] = new_node(t + 1);
              kept.push_back(d);
            }
            arcs.push_back({next_node_of[s], next_node_of[d], g.olabel[a], -1,
                            g.weight[a], 0.0f});
            if (nc < dc) {
              next_cost[d] = nc;
              q.push({nc, d});
            }
          }
        }
      }
    }
    // advance frame
    for (int32_t s : active) {
      cost[s] = kInf;
      node_of[s] = -1;
    }
    std::swap(cost, next_cost);
    std::swap(node_of, next_node_of);
    active = kept;
    if (active.empty()) break;
  }

  int32_t nn = (int32_t)node_time.size();
  // forward-cost over the DAG (nodes are created in topological order since
  // arcs only go to later-created nodes)
  std::vector<float> fwd(nn, kInf), bwd(nn, kInf), nfinal(nn, kInf);
  fwd[0] = 0.0f;
  // same-frame epsilon arcs are not guaranteed topological by node id:
  // relax to fixpoint (bounded; eps chains are short in practice)
  for (int it = 0; it < 16; ++it) {
    bool changed = false;
    for (const auto& a : arcs) {
      float nc = fwd[a.from] + a.graph_cost + a.acoustic_cost;
      if (nc < fwd[a.to]) { fwd[a.to] = nc; changed = true; }
    }
    if (!changed) break;
  }
  // final costs on last-frame live tokens
  float best_total = kInf;
  for (int32_t s : active) {
    int32_t nnode = node_of[s];
    float fc = final_cost[s];
    if (!std::isinf(fc)) {
      nfinal[nnode] = fc;
      float tot = fwd[nnode] + fc;
      if (tot < best_total) best_total = tot;
    }
  }
  if (std::isinf(best_total)) {  // no reachable final: treat live tokens final
    for (int32_t s : active) {
      int32_t nnode = node_of[s];
      nfinal[nnode] = 0.0f;
      if (fwd[nnode] < best_total) best_total = fwd[nnode];
    }
  }
  if (std::isinf(best_total)) return 1;
  // backward costs
  for (int32_t n = 0; n < nn; ++n)
    if (!std::isinf(nfinal[n])) bwd[n] = nfinal[n];
  for (int it = 0; it < 16; ++it) {
    bool changed = false;
    for (int32_t i = (int32_t)arcs.size() - 1; i >= 0; --i) {
      const auto& a = arcs[i];
      float nc = bwd[a.to] + a.graph_cost + a.acoustic_cost;
      if (nc < bwd[a.from]) { bwd[a.from] = nc; changed = true; }
    }
    if (!changed) break;
  }
  // prune: keep arcs on paths within lattice_beam of best
  float keep_cutoff = best_total + lattice_beam;
  std::vector<int32_t> remap(nn, -1);
  int32_t out_n = 0, out_a = 0;
  for (int32_t n = 0; n < nn; ++n) {
    if (fwd[n] + bwd[n] <= keep_cutoff) {
      if (out_n >= node_cap) return 2;
      remap[n] = out_n;
      out_node_time[out_n] = node_time[n];
      out_node_final[out_n] = nfinal[n];
      ++out_n;
    }
  }
  for (const auto& a : arcs) {
    if (remap[a.from] < 0 || remap[a.to] < 0) continue;
    if (fwd[a.from] + a.graph_cost + a.acoustic_cost + bwd[a.to] > keep_cutoff)
      continue;
    if (out_a >= arc_cap) return 2;
    out_arc_from[out_a] = remap[a.from];
    out_arc_to[out_a] = remap[a.to];
    out_arc_word[out_a] = a.word;
    out_arc_pdf[out_a] = a.pdf;
    out_arc_graph[out_a] = a.graph_cost;
    out_arc_acoustic[out_a] = a.acoustic_cost;
    ++out_a;
  }
  *out_narcs = out_a;
  *out_nnodes = out_n;
  return 0;
}

}  // extern "C"
