// The order step of the SIFT frontend: which keypoints OpenCV keeps, and in
// which order, after its detector found them.
//
// OpenCV's SIFT (features2d, detectAndCompute) runs, on the keypoints of
// every octave at the doubled image's scale:
//   KeyPointsFilter::removeDuplicatedSorted: std::sort on (x, y ascending,
//     size descending, angle ascending, response descending, octave
//     descending), then drops each keypoint equal to the last kept one in
//     x, y, size and angle;
//   KeyPointsFilter::retainBest(n): std::nth_element on response
//     (descending) at n - 1, then std::partition of the rest on response >=
//     the n-th one's, which keeps every keypoint tied with it (the count can
//     exceed n).
// The rows it returns come in the order those two calls leave them, which
// only libstdc++'s own std::sort / std::nth_element / std::partition give:
// so this runs them, on the same keypoints, in C++. The caller applies the
// half scale of the first octave afterwards, as OpenCV does.
//
// C interface (ctypes, deepfepe_tpu_torch/ops/sift.py, built with g++ at
// first use):
//   int kp_filter(const float* kp, int n, int n_features, int* out)
//     kp: [n, 6] float32 rows (x, y, size, angle, response, packed octave);
//     out: room for n indices; returns how many it wrote: the kept rows'
//     indices into kp, in OpenCV's order. n_features <= 0 keeps them all.

#include <algorithm>
#include <vector>

namespace {

struct Kp {
  float x, y, size, angle, response;
  int octave;
  int index;  // the row in the caller's array; never compared
};

// KeyPoint12_LessThan (class_id is -1 for every SIFT keypoint).
struct LessThan {
  bool operator()(const Kp& a, const Kp& b) const {
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    if (a.size != b.size) return a.size > b.size;
    if (a.angle != b.angle) return a.angle < b.angle;
    if (a.response != b.response) return a.response > b.response;
    if (a.octave != b.octave) return a.octave > b.octave;
    return false;
  }
};

struct ResponseGreater {
  bool operator()(const Kp& a, const Kp& b) const { return a.response > b.response; }
};

void remove_duplicated_sorted(std::vector<Kp>& kps) {
  const int n = static_cast<int>(kps.size());
  if (n < 2) return;
  std::sort(kps.begin(), kps.end(), LessThan());
  int i = 0;
  for (int j = 1; j < n; ++j) {
    const Kp& a = kps[i];
    const Kp& b = kps[j];
    if (a.x != b.x || a.y != b.y || a.size != b.size || a.angle != b.angle) kps[++i] = kps[j];
  }
  kps.resize(i + 1);
}

void retain_best(std::vector<Kp>& kps, int n_points) {
  if (n_points < 0 || kps.size() <= static_cast<size_t>(n_points)) return;
  if (n_points == 0) {
    kps.clear();
    return;
  }
  std::nth_element(kps.begin(), kps.begin() + n_points - 1, kps.end(), ResponseGreater());
  const float boundary = kps[n_points - 1].response;
  auto end = std::partition(kps.begin() + n_points, kps.end(),
                            [boundary](const Kp& k) { return k.response >= boundary; });
  kps.resize(end - kps.begin());
}

}  // namespace

extern "C" int kp_filter(const float* kp, int n, int n_features, int* out) {
  std::vector<Kp> kps(n);
  for (int i = 0; i < n; ++i) {
    const float* r = kp + 6 * static_cast<long long>(i);
    kps[i] = Kp{r[0], r[1], r[2], r[3], r[4], static_cast<int>(r[5]), i};
  }
  remove_duplicated_sorted(kps);
  if (n_features > 0) retain_best(kps, n_features);
  for (size_t i = 0; i < kps.size(); ++i) out[i] = kps[i].index;
  return static_cast<int>(kps.size());
}
