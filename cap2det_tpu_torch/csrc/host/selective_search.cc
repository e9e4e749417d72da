// Selective Search region proposals (Uijlings et al., IJCV 2013), host C++.
//
// The port's copy of native/selective_search.cc: the same algorithm, the
// same code and the same C ABI, so that built with the same compiler and
// the same flags it gives the same proposals bit for bit. The reference
// extracts proposals with OpenCV ximgproc's SelectiveSearchSegmentation in
// 'quality' mode (dataset-tools/create_coco_selective_search_data.py:
// 105-107); this is a from-scratch implementation: Felzenszwalb-
// Huttenlocher graph segmentation over multiple scales and color spaces,
// followed by hierarchical grouping with color/texture/size/fill
// similarities. Exposed through a C ABI for the ctypes binding in
// cap2det_tpu_torch/native/.
//
// Build: the host compiler, never nvcc, through
// cap2det_tpu_torch/kernels/build.py:host_library (-O3 -std=c++17 -fPIC
// -Wall -pthread). ISO C++17 and no -march keep GCC from contracting
// multiply-adds into FMAs, which would change the bits.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <random>
#include <set>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Union-find with size tracking.
// ---------------------------------------------------------------------------

struct UnionFind {
  std::vector<int> parent, rank_, size;
  explicit UnionFind(int n) : parent(n), rank_(n, 0), size(n, 1) {
    for (int i = 0; i < n; ++i) parent[i] = i;
  }
  int find(int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  int join(int a, int b) {
    a = find(a);
    b = find(b);
    if (a == b) return a;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    if (rank_[a] == rank_[b]) ++rank_[a];
    return a;
  }
};

// ---------------------------------------------------------------------------
// Felzenszwalb-Huttenlocher segmentation.
// ---------------------------------------------------------------------------

struct Edge {
  float weight;
  int a, b;
};

void GaussianBlur(std::vector<float>* img, int h, int w, int c, float sigma) {
  int radius = std::max(1, static_cast<int>(sigma * 3.0f));
  std::vector<float> kernel(2 * radius + 1);
  float sum = 0;
  for (int i = -radius; i <= radius; ++i) {
    kernel[i + radius] = std::exp(-0.5f * i * i / (sigma * sigma));
    sum += kernel[i + radius];
  }
  for (auto& k : kernel) k /= sum;

  std::vector<float> tmp(img->size());
  // Horizontal.
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0;
        for (int i = -radius; i <= radius; ++i) {
          int xx = std::min(std::max(x + i, 0), w - 1);
          acc += kernel[i + radius] * (*img)[(y * w + xx) * c + ch];
        }
        tmp[(y * w + x) * c + ch] = acc;
      }
  // Vertical.
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0;
        for (int i = -radius; i <= radius; ++i) {
          int yy = std::min(std::max(y + i, 0), h - 1);
          acc += kernel[i + radius] * tmp[(yy * w + x) * c + ch];
        }
        (*img)[(y * w + x) * c + ch] = acc;
      }
}

float PixelDiff(const std::vector<float>& img, int c, int i, int j) {
  float d = 0;
  for (int ch = 0; ch < c; ++ch) {
    float v = img[i * c + ch] - img[j * c + ch];
    d += v * v;
  }
  return std::sqrt(d);
}

// Returns a label map [h*w] with contiguous labels, and the label count.
int FelzenszwalbSegment(const std::vector<float>& smoothed, int h, int w,
                        int c, float k, int min_size,
                        std::vector<int>* labels) {
  std::vector<Edge> edges;
  edges.reserve(4 * h * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int i = y * w + x;
      if (x + 1 < w)
        edges.push_back({PixelDiff(smoothed, c, i, i + 1), i, i + 1});
      if (y + 1 < h)
        edges.push_back({PixelDiff(smoothed, c, i, i + w), i, i + w});
      if (x + 1 < w && y + 1 < h)
        edges.push_back({PixelDiff(smoothed, c, i, i + w + 1), i, i + w + 1});
      if (x > 0 && y + 1 < h)
        edges.push_back({PixelDiff(smoothed, c, i, i + w - 1), i, i + w - 1});
    }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.weight < b.weight; });

  UnionFind uf(h * w);
  std::vector<float> threshold(h * w, k);
  for (const Edge& e : edges) {
    int a = uf.find(e.a), b = uf.find(e.b);
    if (a == b) continue;
    if (e.weight <= threshold[a] && e.weight <= threshold[b]) {
      int root = uf.join(a, b);
      threshold[root] = e.weight + k / uf.size[root];
    }
  }
  // Enforce min component size.
  for (const Edge& e : edges) {
    int a = uf.find(e.a), b = uf.find(e.b);
    if (a != b && (uf.size[a] < min_size || uf.size[b] < min_size))
      uf.join(a, b);
  }
  // Relabel contiguously.
  labels->assign(h * w, -1);
  std::map<int, int> remap;
  int next = 0;
  for (int i = 0; i < h * w; ++i) {
    int root = uf.find(i);
    auto it = remap.find(root);
    if (it == remap.end()) it = remap.emplace(root, next++).first;
    (*labels)[i] = it->second;
  }
  return next;
}

// ---------------------------------------------------------------------------
// Region features and similarities.
// ---------------------------------------------------------------------------

constexpr int kColorBins = 25;   // per channel
constexpr int kTextureBins = 10; // per channel per orientation
constexpr int kOrientations = 8;

struct Region {
  int size = 0;
  int y0 = 1 << 30, x0 = 1 << 30, y1 = -1, x1 = -1;
  std::vector<float> color_hist;    // 3 * kColorBins, L1-normalized
  std::vector<float> texture_hist;  // 3 * kOrientations * kTextureBins
  bool alive = false;

  void merge_from(const Region& a, const Region& b) {
    size = a.size + b.size;
    y0 = std::min(a.y0, b.y0);
    x0 = std::min(a.x0, b.x0);
    y1 = std::max(a.y1, b.y1);
    x1 = std::max(a.x1, b.x1);
    color_hist.resize(a.color_hist.size());
    texture_hist.resize(a.texture_hist.size());
    float wa = a.size, wb = b.size, ws = wa + wb;
    for (size_t i = 0; i < color_hist.size(); ++i)
      color_hist[i] = (a.color_hist[i] * wa + b.color_hist[i] * wb) / ws;
    for (size_t i = 0; i < texture_hist.size(); ++i)
      texture_hist[i] = (a.texture_hist[i] * wa + b.texture_hist[i] * wb) / ws;
    alive = true;
  }
};

float HistIntersection(const std::vector<float>& a,
                       const std::vector<float>& b) {
  float s = 0;
  for (size_t i = 0; i < a.size(); ++i) s += std::min(a[i], b[i]);
  return s;
}

struct SimilarityWeights {
  float color = 1, texture = 1, size = 1, fill = 1;
};

float Similarity(const Region& a, const Region& b, int image_size,
                 const SimilarityWeights& wts) {
  float s = 0;
  if (wts.color > 0) s += wts.color * HistIntersection(a.color_hist, b.color_hist);
  if (wts.texture > 0)
    s += wts.texture * HistIntersection(a.texture_hist, b.texture_hist);
  if (wts.size > 0)
    s += wts.size * (1.0f - static_cast<float>(a.size + b.size) / image_size);
  if (wts.fill > 0) {
    int by0 = std::min(a.y0, b.y0), bx0 = std::min(a.x0, b.x0);
    int by1 = std::max(a.y1, b.y1), bx1 = std::max(a.x1, b.x1);
    float bb = static_cast<float>(by1 - by0 + 1) * (bx1 - bx0 + 1);
    s += wts.fill * (1.0f - (bb - a.size - b.size) / image_size);
  }
  return s;
}

// ---------------------------------------------------------------------------
// Hierarchical grouping over one segmentation.
// ---------------------------------------------------------------------------

struct Box {
  int y0, x0, y1, x1;
  float priority;
};

void HierarchicalGrouping(const std::vector<float>& img,    // color space img
                          const std::vector<float>& gray,   // gradients base
                          const std::vector<int>& labels, int num_regions,
                          int h, int w, const SimilarityWeights& wts,
                          float rank_scale, std::vector<Box>* out) {
  // Build per-region features.
  std::vector<Region> regions(2 * num_regions);
  for (int r = 0; r < num_regions; ++r) {
    regions[r].color_hist.assign(3 * kColorBins, 0.f);
    regions[r].texture_hist.assign(3 * kOrientations * kTextureBins, 0.f);
    regions[r].alive = true;
  }

  // Gradients for texture histograms.
  std::vector<float> gx(h * w * 3), gy(h * w * 3);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < 3; ++ch) {
        int xm = std::max(x - 1, 0), xp = std::min(x + 1, w - 1);
        int ym = std::max(y - 1, 0), yp = std::min(y + 1, h - 1);
        gx[(y * w + x) * 3 + ch] =
            img[(y * w + xp) * 3 + ch] - img[(y * w + xm) * 3 + ch];
        gy[(y * w + x) * 3 + ch] =
            img[(yp * w + x) * 3 + ch] - img[(ym * w + x) * 3 + ch];
      }

  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int i = y * w + x;
      Region& reg = regions[labels[i]];
      ++reg.size;
      reg.y0 = std::min(reg.y0, y);
      reg.x0 = std::min(reg.x0, x);
      reg.y1 = std::max(reg.y1, y);
      reg.x1 = std::max(reg.x1, x);
      for (int ch = 0; ch < 3; ++ch) {
        float v = img[i * 3 + ch];
        int bin = std::min(static_cast<int>(v * kColorBins), kColorBins - 1);
        reg.color_hist[ch * kColorBins + bin] += 1.f;
        float dx = gx[i * 3 + ch], dy = gy[i * 3 + ch];
        float mag = std::sqrt(dx * dx + dy * dy);
        float ang = std::atan2(dy, dx) + 3.14159265f;
        int ori = std::min(static_cast<int>(ang / (2 * 3.14159265f) *
                                            kOrientations),
                           kOrientations - 1);
        int tbin = std::min(static_cast<int>(std::min(mag, 1.0f) * kTextureBins),
                            kTextureBins - 1);
        reg.texture_hist[(ch * kOrientations + ori) * kTextureBins + tbin] +=
            1.f;
      }
    }
  for (int r = 0; r < num_regions; ++r) {
    for (auto& v : regions[r].color_hist) v /= regions[r].size;
    for (auto& v : regions[r].texture_hist) v /= regions[r].size;
  }

  // Neighbor set.
  std::set<std::pair<int, int>> neighbors;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int a = labels[y * w + x];
      if (x + 1 < w) {
        int b = labels[y * w + x + 1];
        if (a != b) neighbors.emplace(std::min(a, b), std::max(a, b));
      }
      if (y + 1 < h) {
        int b = labels[(y + 1) * w + x];
        if (a != b) neighbors.emplace(std::min(a, b), std::max(a, b));
      }
    }

  int image_size = h * w;
  // Initial boxes (every base region is a proposal too).
  for (int r = 0; r < num_regions; ++r)
    out->push_back({regions[r].y0, regions[r].x0, regions[r].y1, regions[r].x1,
                    rank_scale * 1.0f});

  std::map<std::pair<int, int>, float> sims;
  for (auto& nb : neighbors)
    sims[nb] = Similarity(regions[nb.first], regions[nb.second], image_size, wts);

  int next_label = num_regions;
  int merges = 0;
  while (!sims.empty()) {
    auto best = std::max_element(
        sims.begin(), sims.end(),
        [](const auto& a, const auto& b) { return a.second < b.second; });
    int ra = best->first.first, rb = best->first.second;

    Region& merged = regions[next_label];
    merged.merge_from(regions[ra], regions[rb]);
    regions[ra].alive = false;
    regions[rb].alive = false;

    // Collect neighbors of ra/rb, drop stale similarities.
    std::set<int> touching;
    for (auto it = sims.begin(); it != sims.end();) {
      int u = it->first.first, v = it->first.second;
      if (u == ra || u == rb || v == ra || v == rb) {
        int other = (u == ra || u == rb) ? v : u;
        if (other != ra && other != rb) touching.insert(other);
        it = sims.erase(it);
      } else {
        ++it;
      }
    }
    for (int other : touching) {
      if (!regions[other].alive) continue;
      auto key = std::make_pair(std::min(other, next_label),
                                std::max(other, next_label));
      sims[key] = Similarity(regions[other], merged, image_size, wts);
    }
    ++merges;
    // Later merges (larger regions) get higher priority rank: the classic
    // implementation ranks a proposal by the hierarchy level it appears at.
    out->push_back({merged.y0, merged.x0, merged.y1, merged.x1,
                    rank_scale * (1.0f + merges)});
    ++next_label;
    if (next_label >= static_cast<int>(regions.size())) break;
  }
}

// ---------------------------------------------------------------------------
// Color spaces.
// ---------------------------------------------------------------------------

void RGBToHSV(const uint8_t* rgb, int n, std::vector<float>* out) {
  out->resize(n * 3);
  for (int i = 0; i < n; ++i) {
    float r = rgb[i * 3] / 255.f, g = rgb[i * 3 + 1] / 255.f,
          b = rgb[i * 3 + 2] / 255.f;
    float mx = std::max({r, g, b}), mn = std::min({r, g, b});
    float d = mx - mn;
    float hh = 0;
    if (d > 0) {
      if (mx == r)
        hh = std::fmod((g - b) / d, 6.f);
      else if (mx == g)
        hh = (b - r) / d + 2.f;
      else
        hh = (r - g) / d + 4.f;
      hh /= 6.f;
      if (hh < 0) hh += 1.f;
    }
    (*out)[i * 3] = hh;
    (*out)[i * 3 + 1] = mx > 0 ? d / mx : 0.f;
    (*out)[i * 3 + 2] = mx;
  }
}

void RGBToNormalized(const uint8_t* rgb, int n, std::vector<float>* out) {
  out->resize(n * 3);
  for (int i = 0; i < n; ++i) {
    float r = rgb[i * 3], g = rgb[i * 3 + 1], b = rgb[i * 3 + 2];
    float s = r + g + b + 1e-6f;
    (*out)[i * 3] = r / s;
    (*out)[i * 3 + 1] = g / s;
    (*out)[i * 3 + 2] = b / s;
  }
}

void Grayscale(const uint8_t* rgb, int n, std::vector<float>* out) {
  out->resize(n);
  for (int i = 0; i < n; ++i)
    (*out)[i] = (0.299f * rgb[i * 3] + 0.587f * rgb[i * 3 + 1] +
                 0.114f * rgb[i * 3 + 2]) /
                255.f;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Returns the number of boxes written (<= max_boxes). Boxes are
// [ymin, xmin, ymax, xmax] normalized to [0, 1], ranked as in the classic
// algorithm (small hierarchy levels across strategies first, randomized
// tie-break with the given seed).
int cap2det_selective_search(const uint8_t* rgb, int height, int width,
                             int quality_mode, int min_box_side,
                             unsigned int seed, float* out_boxes,
                             int max_boxes) {
  if (height <= 0 || width <= 0) return 0;
  int n = height * width;

  std::vector<float> hsv, rgbn;
  RGBToHSV(rgb, n, &hsv);
  std::vector<Box> boxes;

  std::vector<float> ks = quality_mode ? std::vector<float>{50, 100, 150, 300}
                                       : std::vector<float>{100, 200};
  std::vector<const std::vector<float>*> spaces{&hsv};
  if (quality_mode) {
    RGBToNormalized(rgb, n, &rgbn);
    spaces.push_back(&rgbn);
  }
  std::vector<SimilarityWeights> strategies;
  strategies.push_back({1, 1, 1, 1});
  if (quality_mode) {
    strategies.push_back({0, 1, 1, 1});  // no color
    strategies.push_back({1, 0, 1, 1});  // no texture
  }

  std::vector<float> gray;
  Grayscale(rgb, n, &gray);

  int strategy_idx = 0;
  for (const auto* space : spaces) {
    for (float k : ks) {
      std::vector<float> smoothed = *space;
      GaussianBlur(&smoothed, height, width, 3, 0.8f);
      std::vector<int> labels;
      // Classic k values assume 0-255 pixel range; channels here are
      // [0, 1], so the merge threshold is scaled down accordingly while
      // min component size stays in pixels.
      int num_regions =
          FelzenszwalbSegment(smoothed, height, width, 3, k / 255.f,
                              static_cast<int>(k), &labels);
      if (num_regions <= 1) continue;
      const SimilarityWeights& wts =
          strategies[strategy_idx % strategies.size()];
      ++strategy_idx;
      HierarchicalGrouping(*space, gray, labels, num_regions, height, width,
                           wts, 1.0f, &boxes);
    }
  }

  // Filter, dedup, rank.
  std::mt19937 rng(seed);
  std::uniform_real_distribution<float> jitter(0.f, 1.f);
  std::set<std::tuple<int, int, int, int>> seen;
  std::vector<Box> unique;
  for (auto& b : boxes) {
    if (b.y1 - b.y0 + 1 < min_box_side || b.x1 - b.x0 + 1 < min_box_side)
      continue;
    auto key = std::make_tuple(b.y0, b.x0, b.y1, b.x1);
    if (seen.count(key)) continue;
    seen.insert(key);
    b.priority *= jitter(rng);  // classic randomized ranking
    unique.push_back(b);
  }
  std::sort(unique.begin(), unique.end(),
            [](const Box& a, const Box& b) { return a.priority < b.priority; });

  int count = std::min<int>(unique.size(), max_boxes);
  for (int i = 0; i < count; ++i) {
    out_boxes[i * 4] = static_cast<float>(unique[i].y0) / height;
    out_boxes[i * 4 + 1] = static_cast<float>(unique[i].x0) / width;
    out_boxes[i * 4 + 2] = static_cast<float>(unique[i].y1 + 1) / height;
    out_boxes[i * 4 + 3] = static_cast<float>(unique[i].x1 + 1) / width;
  }
  return count;
}

// Felzenszwalb segmentation alone (exposed for tests): writes labels
// [height*width] and returns the number of segments.
int cap2det_felzenszwalb(const uint8_t* rgb, int height, int width, float k,
                         int min_size, int* out_labels) {
  int n = height * width;
  std::vector<float> img(n * 3);
  for (int i = 0; i < n * 3; ++i) img[i] = rgb[i] / 255.f;
  GaussianBlur(&img, height, width, 3, 0.8f);
  std::vector<int> labels;
  int count = FelzenszwalbSegment(img, height, width, 3, k / 255.f, min_size,
                                  &labels);
  std::memcpy(out_labels, labels.data(), n * sizeof(int));
  return count;
}

}  // extern "C"
