// Native binned-SAH BVH builder, the host-side analog of optixAccelBuild
// (reference: src/render/optix/OptixRender.cpp:388-496 builds GAS/IAS through
// the OptiX runtime; here the acceleration structure is built on the host CPU
// and uploaded as arrays).
//
// The port's copy of strelka_tpu/native/bvh_builder.cpp, code unchanged, so
// that both packages build the same tree on the same host. Same node layout
// and algorithm as _build_bvh_numpy in strelka_tpu_torch/ops/bvh.py, in f32:
// 16-bin SAH, median-split fallback, leaves <= max_leaf. Exposed via a C ABI
// for ctypes.
//
// Build: see strelka_tpu_torch/native/__init__.py (g++ -O3 -march=native
// -shared -fPIC, into strelka_tpu_torch/_build/native/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3 () : x(0), y(0), z(0) {}
    Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return Vec3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return Vec3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct Aabb {
    Vec3 lo, hi;
    Aabb()
        : lo(std::numeric_limits<float>::max(), std::numeric_limits<float>::max(),
             std::numeric_limits<float>::max()),
          hi(-std::numeric_limits<float>::max(), -std::numeric_limits<float>::max(),
             -std::numeric_limits<float>::max()) {}
    void grow(const Aabb& o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void grow(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float half_area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const float* v0;
    const float* e1;
    const float* e2;
    int64_t n;
    int max_leaf;

    std::vector<Aabb> tri_box;
    std::vector<Vec3> centroid;
    std::vector<int64_t> order;

    std::vector<float> bb_min, bb_max;
    std::vector<int32_t> left, right, start, count;

    int32_t new_node() {
        bb_min.insert(bb_min.end(), {0, 0, 0});
        bb_max.insert(bb_max.end(), {0, 0, 0});
        left.push_back(0);
        right.push_back(0);
        start.push_back(0);
        count.push_back(0);
        return (int32_t)count.size() - 1;
    }

    void build() {
        tri_box.resize(n);
        centroid.resize(n);
        order.resize(n);
        for (int64_t i = 0; i < n; ++i) {
            Vec3 p0(v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]);
            Vec3 p1(p0.x + e1[3 * i], p0.y + e1[3 * i + 1], p0.z + e1[3 * i + 2]);
            Vec3 p2(p0.x + e2[3 * i], p0.y + e2[3 * i + 1], p0.z + e2[3 * i + 2]);
            Aabb b;
            b.grow(p0);
            b.grow(p1);
            b.grow(p2);
            tri_box[i] = b;
            centroid[i] = Vec3(0.5f * (b.lo.x + b.hi.x), 0.5f * (b.lo.y + b.hi.y),
                               0.5f * (b.lo.z + b.hi.z));
            order[i] = i;
        }
        struct Task {
            int32_t node;
            int64_t lo, hi;
        };
        std::vector<Task> stack;
        int32_t root = new_node();
        stack.push_back({root, 0, n});
        constexpr int NBINS = 16;
        while (!stack.empty()) {
            Task task = stack.back();
            stack.pop_back();
            Aabb nb;
            Aabb cb;
            for (int64_t i = task.lo; i < task.hi; ++i) {
                nb.grow(tri_box[order[i]]);
                cb.grow(centroid[order[i]]);
            }
            std::memcpy(&bb_min[3 * task.node], &nb.lo, 12);
            std::memcpy(&bb_max[3 * task.node], &nb.hi, 12);
            int64_t num = task.hi - task.lo;
            if (num <= max_leaf) {
                start[task.node] = (int32_t)task.lo;
                count[task.node] = (int32_t)num;
                continue;
            }
            float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
            int axis = 0;
            if (ext[1] > ext[axis]) axis = 1;
            if (ext[2] > ext[axis]) axis = 2;
            int64_t mid = -1;
            if (ext[axis] >= 1e-12f) {
                const float cmin = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
                const float scale = NBINS * (1.0f - 1e-6f) / ext[axis];
                int64_t cnt[NBINS] = {};
                Aabb bins[NBINS];
                auto bin_of = [&](int64_t idx) {
                    const Vec3& c = centroid[idx];
                    float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                    int b = (int)((v - cmin) * scale);
                    return std::min(std::max(b, 0), NBINS - 1);
                };
                for (int64_t i = task.lo; i < task.hi; ++i) {
                    int b = bin_of(order[i]);
                    cnt[b]++;
                    bins[b].grow(tri_box[order[i]]);
                }
                // sweep
                float larea[NBINS - 1], rarea[NBINS - 1];
                int64_t lcnt[NBINS - 1], rcnt[NBINS - 1];
                {
                    Aabb acc;
                    int64_t c = 0;
                    for (int b = 0; b < NBINS - 1; ++b) {
                        acc.grow(bins[b]);
                        c += cnt[b];
                        larea[b] = acc.half_area();
                        lcnt[b] = c;
                    }
                }
                {
                    Aabb acc;
                    int64_t c = 0;
                    for (int b = NBINS - 1; b >= 1; --b) {
                        acc.grow(bins[b]);
                        c += cnt[b];
                        rarea[b - 1] = acc.half_area();
                        rcnt[b - 1] = c;
                    }
                }
                float best_cost = std::numeric_limits<float>::max();
                int best = -1;
                for (int b = 0; b < NBINS - 1; ++b) {
                    if (lcnt[b] == 0 || rcnt[b] == 0) continue;
                    float cost = larea[b] * lcnt[b] + rarea[b] * rcnt[b];
                    if (cost < best_cost) {
                        best_cost = cost;
                        best = b;
                    }
                }
                if (best >= 0) {
                    auto it = std::partition(
                        order.begin() + task.lo, order.begin() + task.hi,
                        [&](int64_t idx) { return bin_of(idx) <= best; });
                    mid = it - order.begin();
                }
            }
            if (mid <= task.lo || mid >= task.hi) {
                mid = task.lo + num / 2;
                std::nth_element(
                    order.begin() + task.lo, order.begin() + mid, order.begin() + task.hi,
                    [&](int64_t a, int64_t b) {
                        const Vec3& ca = centroid[a];
                        const Vec3& cbx = centroid[b];
                        float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                        float vb = axis == 0 ? cbx.x : (axis == 1 ? cbx.y : cbx.z);
                        return va < vb;
                    });
            }
            int32_t l = new_node();
            int32_t r = new_node();
            left[task.node] = l;
            right[task.node] = r;
            stack.push_back({r, mid, task.hi});
            stack.push_back({l, task.lo, mid});
        }
    }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error. Output buffers must
// hold at least 2*num_tris entries (nodes) / num_tris entries (perm).
int64_t strelka_build_bvh(const float* v0, const float* e1, const float* e2,
                          int64_t num_tris, int max_leaf, float* out_bb_min,
                          float* out_bb_max, int32_t* out_left, int32_t* out_right,
                          int32_t* out_start, int32_t* out_count, int64_t* out_perm) {
    if (num_tris <= 0) return -1;
    Builder b;
    b.v0 = v0;
    b.e1 = e1;
    b.e2 = e2;
    b.n = num_tris;
    b.max_leaf = max_leaf;
    b.build();
    int64_t n_nodes = (int64_t)b.count.size();
    if (n_nodes > 2 * num_tris) return -1;
    std::memcpy(out_bb_min, b.bb_min.data(), n_nodes * 12);
    std::memcpy(out_bb_max, b.bb_max.data(), n_nodes * 12);
    std::memcpy(out_left, b.left.data(), n_nodes * 4);
    std::memcpy(out_right, b.right.data(), n_nodes * 4);
    std::memcpy(out_start, b.start.data(), n_nodes * 4);
    std::memcpy(out_count, b.count.data(), n_nodes * 4);
    std::memcpy(out_perm, b.order.data(), num_tris * 8);
    return n_nodes;
}
}
