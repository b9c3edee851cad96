// Array-pooled Guttman R-tree over 2-D points with the reference's four
// split strategies (linear / quadratic / greene / rstar).
//
// Semantic mirror of Reindexer's cpp_src/core/index/rtree/
// (rtree.h Guttman tree, guttmansplitter.h base, linearsplitter.h,
// quadraticsplitter.h, greenesplitter.h, rstarsplitter.h; wired in
// indexrtree.cc with MaxEntries 32 (linear/quadratic) or 16
// (greene/rstar), MinEntries 4). Implementation is original, written from
// the published algorithms (Guttman'84, Greene'89, Beckmann'90): nodes
// live in one contiguous pool (no per-node allocation), leaves hold
// parallel id/x/y arrays, and DWithin descends with a circle-vs-rect
// test + exact refine.
//
// CPython API (capsule handle):
//   rtree_new(split_type, max_entries) -> capsule
//   rtree_insert(cap, id, x, y)
//   rtree_remove(cap, id, x, y) -> bool
//   rtree_dwithin(cap, x, y, distance) -> bytes(int32 ids)
//   rtree_stats(cap) -> (height, nodes, points)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kLinear = 0, kQuadratic = 1, kGreene = 2, kRStar = 3;

struct Rect {
    double minx, miny, maxx, maxy;
    static Rect empty() {
        double inf = std::numeric_limits<double>::infinity();
        return {inf, inf, -inf, -inf};
    }
    void add(double x, double y) {
        minx = std::min(minx, x);
        miny = std::min(miny, y);
        maxx = std::max(maxx, x);
        maxy = std::max(maxy, y);
    }
    void add(const Rect& o) {
        minx = std::min(minx, o.minx);
        miny = std::min(miny, o.miny);
        maxx = std::max(maxx, o.maxx);
        maxy = std::max(maxy, o.maxy);
    }
    double area() const { return (maxx - minx) * (maxy - miny); }
    double margin() const { return (maxx - minx) + (maxy - miny); }
    double enlargement(double x, double y) const {
        double nx0 = std::min(minx, x), ny0 = std::min(miny, y);
        double nx1 = std::max(maxx, x), ny1 = std::max(maxy, y);
        return (nx1 - nx0) * (ny1 - ny0) - area();
    }
    double overlap(const Rect& o) const {
        double w = std::min(maxx, o.maxx) - std::max(minx, o.minx);
        double h = std::min(maxy, o.maxy) - std::max(miny, o.miny);
        return (w > 0 && h > 0) ? w * h : 0.0;
    }
    bool intersects_circle(double cx, double cy, double r) const {
        double dx = cx < minx ? minx - cx : (cx > maxx ? cx - maxx : 0.0);
        double dy = cy < miny ? miny - cy : (cy > maxy ? cy - maxy : 0.0);
        return dx * dx + dy * dy <= r * r;
    }
};

struct Node {
    Rect mbr;
    bool leaf = true;
    std::vector<int32_t> child;           // node ids (internal)
    std::vector<int32_t> ids;             // point ids (leaf)
    std::vector<double> xs, ys;           // point coords (leaf)
    int32_t parent = -1;
    size_t size() const { return leaf ? ids.size() : child.size(); }
};

struct RTree {
    int split_type;
    size_t M;                              // max entries per node
    size_t m = 4;                          // min fill
    std::vector<Node> nodes;
    int32_t root;
    int height = 1;                        // levels (1 = root is leaf)
    size_t count = 0;

    explicit RTree(int st, size_t max_entries)
        : split_type(st), M(max_entries) {
        nodes.emplace_back();
        nodes[0].mbr = Rect::empty();
        root = 0;
    }

    int32_t alloc() {
        nodes.emplace_back();
        return (int32_t)nodes.size() - 1;
    }

    void recompute_mbr(int32_t n) {
        Node& nd = nodes[n];
        Rect r = Rect::empty();
        if (nd.leaf) {
            for (size_t i = 0; i < nd.ids.size(); i++) r.add(nd.xs[i], nd.ys[i]);
        } else {
            for (int32_t c : nd.child) r.add(nodes[c].mbr);
        }
        nd.mbr = r;
    }

    // ---- choose leaf (Guttman ChooseLeaf; R*: min overlap at leaf level)
    int32_t choose_leaf(double x, double y) {
        int32_t n = root;
        while (!nodes[n].leaf) {
            Node& nd = nodes[n];
            bool next_is_leaf = nodes[nd.child[0]].leaf;
            int32_t best = nd.child[0];
            if (split_type == kRStar && next_is_leaf) {
                // Beckmann: minimum overlap enlargement, ties by area
                // enlargement then area
                double bestOvEnl = std::numeric_limits<double>::infinity();
                double bestEnl = bestOvEnl, bestArea = bestOvEnl;
                for (int32_t c : nd.child) {
                    Rect grown = nodes[c].mbr;
                    grown.add(x, y);
                    double ov0 = 0, ov1 = 0;
                    for (int32_t o : nd.child) {
                        if (o == c) continue;
                        ov0 += nodes[c].mbr.overlap(nodes[o].mbr);
                        ov1 += grown.overlap(nodes[o].mbr);
                    }
                    double ovEnl = ov1 - ov0;
                    double enl = nodes[c].mbr.enlargement(x, y);
                    double ar = nodes[c].mbr.area();
                    if (ovEnl < bestOvEnl ||
                        (ovEnl == bestOvEnl &&
                         (enl < bestEnl ||
                          (enl == bestEnl && ar < bestArea)))) {
                        bestOvEnl = ovEnl;
                        bestEnl = enl;
                        bestArea = ar;
                        best = c;
                    }
                }
            } else {
                double bestEnl = std::numeric_limits<double>::infinity();
                double bestArea = bestEnl;
                for (int32_t c : nd.child) {
                    double enl = nodes[c].mbr.enlargement(x, y);
                    double ar = nodes[c].mbr.area();
                    if (enl < bestEnl || (enl == bestEnl && ar < bestArea)) {
                        bestEnl = enl;
                        bestArea = ar;
                        best = c;
                    }
                }
            }
            n = best;
        }
        return n;
    }

    // ---- leaf split entry view --------------------------------------
    struct Entry {
        Rect r;
        int32_t id;        // point id (leaf) or node id (internal)
        double x, y;       // point coords (leaf)
    };

    std::vector<Entry> collect_entries(int32_t n) {
        Node& nd = nodes[n];
        std::vector<Entry> es;
        es.reserve(nd.size());
        if (nd.leaf) {
            for (size_t i = 0; i < nd.ids.size(); i++) {
                Rect r{nd.xs[i], nd.ys[i], nd.xs[i], nd.ys[i]};
                es.push_back({r, nd.ids[i], nd.xs[i], nd.ys[i]});
            }
        } else {
            for (int32_t c : nd.child) es.push_back({nodes[c].mbr, c, 0, 0});
        }
        return es;
    }

    static Rect union_of(const std::vector<Entry>& es,
                         const std::vector<int>& idx) {
        Rect r = Rect::empty();
        for (int i : idx) r.add(es[i].r);
        return r;
    }

    // group assignment shared by linear/quadratic after seed picking
    void distribute(const std::vector<Entry>& es, int s1, int s2,
                    bool quadratic, std::vector<int>& g1,
                    std::vector<int>& g2) {
        size_t n = es.size();
        std::vector<bool> used(n, false);
        used[s1] = used[s2] = true;
        g1 = {s1};
        g2 = {s2};
        Rect r1 = es[s1].r, r2 = es[s2].r;
        size_t remaining = n - 2;
        while (remaining) {
            // min-fill forcing (Guttman): if one group must take all rest
            if (g1.size() + remaining == m) {
                for (size_t i = 0; i < n; i++)
                    if (!used[i]) { g1.push_back((int)i); r1.add(es[i].r); }
                break;
            }
            if (g2.size() + remaining == m) {
                for (size_t i = 0; i < n; i++)
                    if (!used[i]) { g2.push_back((int)i); r2.add(es[i].r); }
                break;
            }
            int pick = -1;
            if (quadratic) {
                // PickNext: entry with max |d1 - d2|
                double bestDiff = -1;
                for (size_t i = 0; i < n; i++) {
                    if (used[i]) continue;
                    Rect u1 = r1; u1.add(es[i].r);
                    Rect u2 = r2; u2.add(es[i].r);
                    double d1 = u1.area() - r1.area();
                    double d2 = u2.area() - r2.area();
                    double diff = std::fabs(d1 - d2);
                    if (diff > bestDiff) { bestDiff = diff; pick = (int)i; }
                }
            } else {
                for (size_t i = 0; i < n; i++)
                    if (!used[i]) { pick = (int)i; break; }
            }
            used[pick] = true;
            remaining--;
            Rect u1 = r1; u1.add(es[pick].r);
            Rect u2 = r2; u2.add(es[pick].r);
            double d1 = u1.area() - r1.area();
            double d2 = u2.area() - r2.area();
            bool to1 = d1 < d2 ||
                       (d1 == d2 && (r1.area() < r2.area() ||
                                     (r1.area() == r2.area() &&
                                      g1.size() <= g2.size())));
            if (to1) { g1.push_back(pick); r1 = u1; }
            else { g2.push_back(pick); r2 = u2; }
        }
    }

    void split_entries(std::vector<Entry>& es, std::vector<int>& g1,
                       std::vector<int>& g2) {
        size_t n = es.size();
        if (split_type == kLinear) {
            // LinearPickSeeds: greatest normalized separation over dims
            int lox = 0, hix = 0, loy = 0, hiy = 0;  // extreme entries
            double minx = 1e300, maxx = -1e300, miny = 1e300, maxy = -1e300;
            int hiLowX = 0, loHighX = 0, hiLowY = 0, loHighY = 0;
            double hlx = -1e300, lhx = 1e300, hly = -1e300, lhy = 1e300;
            for (size_t i = 0; i < n; i++) {
                const Rect& r = es[i].r;
                if (r.minx < minx) { minx = r.minx; lox = (int)i; }
                if (r.maxx > maxx) { maxx = r.maxx; hix = (int)i; }
                if (r.miny < miny) { miny = r.miny; loy = (int)i; }
                if (r.maxy > maxy) { maxy = r.maxy; hiy = (int)i; }
                if (r.minx > hlx) { hlx = r.minx; hiLowX = (int)i; }
                if (r.maxx < lhx) { lhx = r.maxx; loHighX = (int)i; }
                if (r.miny > hly) { hly = r.miny; hiLowY = (int)i; }
                if (r.maxy < lhy) { lhy = r.maxy; loHighY = (int)i; }
            }
            double wx = maxx - minx, wy = maxy - miny;
            double sepx = wx > 0 ? (hlx - lhx) / wx : -1;
            double sepy = wy > 0 ? (hly - lhy) / wy : -1;
            int s1, s2;
            if (sepx >= sepy) { s1 = hiLowX; s2 = loHighX; }
            else { s1 = hiLowY; s2 = loHighY; }
            if (s1 == s2) s2 = (s1 + 1) % (int)n;
            distribute(es, s1, s2, false, g1, g2);
            (void)lox; (void)hix; (void)loy; (void)hiy;
            return;
        }
        if (split_type == kQuadratic) {
            // PickSeeds: pair with max dead area
            int s1 = 0, s2 = 1;
            double worst = -1e300;
            for (size_t i = 0; i < n; i++)
                for (size_t j = i + 1; j < n; j++) {
                    Rect u = es[i].r;
                    u.add(es[j].r);
                    double d = u.area() - es[i].r.area() - es[j].r.area();
                    if (d > worst) { worst = d; s1 = (int)i; s2 = (int)j; }
                }
            distribute(es, s1, s2, true, g1, g2);
            return;
        }
        if (split_type == kGreene) {
            // Greene'89: pick quadratic seeds, choose the axis of their
            // greatest normalized separation, sort along it, halve
            int s1 = 0, s2 = 1;
            double worst = -1e300;
            for (size_t i = 0; i < n; i++)
                for (size_t j = i + 1; j < n; j++) {
                    Rect u = es[i].r;
                    u.add(es[j].r);
                    double d = u.area() - es[i].r.area() - es[j].r.area();
                    if (d > worst) { worst = d; s1 = (int)i; s2 = (int)j; }
                }
            Rect all = Rect::empty();
            for (auto& e : es) all.add(e.r);
            double wx = std::max(all.maxx - all.minx, 1e-300);
            double wy = std::max(all.maxy - all.miny, 1e-300);
            double sepx = std::fabs(es[s1].r.minx - es[s2].r.minx) / wx;
            double sepy = std::fabs(es[s1].r.miny - es[s2].r.miny) / wy;
            bool byx = sepx >= sepy;
            std::vector<int> order(n);
            for (size_t i = 0; i < n; i++) order[i] = (int)i;
            std::sort(order.begin(), order.end(), [&](int a, int b) {
                return byx ? es[a].r.minx < es[b].r.minx
                           : es[a].r.miny < es[b].r.miny;
            });
            size_t half = n / 2;
            g1.assign(order.begin(), order.begin() + half);
            g2.assign(order.begin() + half, order.end());
            return;
        }
        // R*: choose axis by min margin sum; distribution by min overlap
        std::vector<int> best_g1, best_g2;
        double bestMargin = 1e300;
        int bestAxis = 0;
        std::vector<int> order(n);
        for (int axis = 0; axis < 2; axis++) {
            for (int bound = 0; bound < 2; bound++) {
                for (size_t i = 0; i < n; i++) order[i] = (int)i;
                std::sort(order.begin(), order.end(), [&](int a, int b) {
                    const Rect &ra = es[a].r, &rb = es[b].r;
                    double va = axis == 0 ? (bound ? ra.maxx : ra.minx)
                                          : (bound ? ra.maxy : ra.miny);
                    double vb = axis == 0 ? (bound ? rb.maxx : rb.minx)
                                          : (bound ? rb.maxy : rb.miny);
                    return va < vb;
                });
                double marginSum = 0;
                for (size_t k = m; k + m <= n; k++) {
                    Rect r1 = Rect::empty(), r2 = Rect::empty();
                    for (size_t i = 0; i < k; i++) r1.add(es[order[i]].r);
                    for (size_t i = k; i < n; i++) r2.add(es[order[i]].r);
                    marginSum += r1.margin() + r2.margin();
                }
                if (marginSum < bestMargin) {
                    bestMargin = marginSum;
                    bestAxis = axis * 2 + bound;
                }
            }
        }
        int axis = bestAxis / 2, bound = bestAxis % 2;
        for (size_t i = 0; i < n; i++) order[i] = (int)i;
        std::sort(order.begin(), order.end(), [&](int a, int b) {
            const Rect &ra = es[a].r, &rb = es[b].r;
            double va = axis == 0 ? (bound ? ra.maxx : ra.minx)
                                  : (bound ? ra.maxy : ra.miny);
            double vb = axis == 0 ? (bound ? rb.maxx : rb.minx)
                                  : (bound ? rb.maxy : rb.miny);
            return va < vb;
        });
        double bestOv = 1e300, bestArea = 1e300;
        size_t bestK = m;
        for (size_t k = m; k + m <= n; k++) {
            Rect r1 = Rect::empty(), r2 = Rect::empty();
            for (size_t i = 0; i < k; i++) r1.add(es[order[i]].r);
            for (size_t i = k; i < n; i++) r2.add(es[order[i]].r);
            double ov = r1.overlap(r2);
            double ar = r1.area() + r2.area();
            if (ov < bestOv || (ov == bestOv && ar < bestArea)) {
                bestOv = ov;
                bestArea = ar;
                bestK = k;
            }
        }
        g1.assign(order.begin(), order.begin() + bestK);
        g2.assign(order.begin() + bestK, order.end());
        (void)best_g1;
        (void)best_g2;
    }

    void fill_node(int32_t n, const std::vector<Entry>& es,
                   const std::vector<int>& idx, bool leaf) {
        Node& nd = nodes[n];
        nd.leaf = leaf;
        nd.child.clear();
        nd.ids.clear();
        nd.xs.clear();
        nd.ys.clear();
        Rect r = Rect::empty();
        for (int i : idx) {
            if (leaf) {
                nd.ids.push_back(es[i].id);
                nd.xs.push_back(es[i].x);
                nd.ys.push_back(es[i].y);
            } else {
                nd.child.push_back(es[i].id);
                nodes[es[i].id].parent = n;
            }
            r.add(es[i].r);
        }
        nd.mbr = r;
    }

    // split node n; returns the new sibling id
    int32_t split(int32_t n) {
        std::vector<Entry> es = collect_entries(n);
        std::vector<int> g1, g2;
        split_entries(es, g1, g2);
        bool leaf = nodes[n].leaf;
        int32_t sib = alloc();
        nodes[sib].parent = nodes[n].parent;
        fill_node(n, es, g1, leaf);
        fill_node(sib, es, g2, leaf);
        return sib;
    }

    void adjust_upward(int32_t n, int32_t split_sibling) {
        while (true) {
            int32_t p = nodes[n].parent;
            if (p < 0) {
                if (split_sibling >= 0) {
                    // grow a new root
                    int32_t nr = alloc();
                    Node& r = nodes[nr];
                    r.leaf = false;
                    r.child = {n, split_sibling};
                    nodes[n].parent = nr;
                    nodes[split_sibling].parent = nr;
                    recompute_mbr(nr);
                    root = nr;
                    height++;
                }
                return;
            }
            recompute_mbr(p);
            if (split_sibling >= 0) {
                nodes[p].child.push_back(split_sibling);
                nodes[split_sibling].parent = p;
                recompute_mbr(p);
                split_sibling = nodes[p].size() > M ? split(p) : -1;
            }
            n = p;
        }
    }

    void insert(int32_t id, double x, double y) {
        int32_t leaf = choose_leaf(x, y);
        Node& nd = nodes[leaf];
        nd.ids.push_back(id);
        nd.xs.push_back(x);
        nd.ys.push_back(y);
        nd.mbr.add(x, y);
        count++;
        int32_t sib = nd.ids.size() > M ? split(leaf) : -1;
        adjust_upward(leaf, sib);
    }

    int32_t find_leaf(int32_t n, int32_t id, double x, double y) {
        Node& nd = nodes[n];
        if (nd.leaf) {
            for (size_t i = 0; i < nd.ids.size(); i++)
                if (nd.ids[i] == id && nd.xs[i] == x && nd.ys[i] == y)
                    return n;
            return -1;
        }
        for (int32_t c : nd.child) {
            const Rect& r = nodes[c].mbr;
            if (x >= r.minx && x <= r.maxx && y >= r.miny && y <= r.maxy) {
                int32_t f = find_leaf(c, id, x, y);
                if (f >= 0) return f;
            }
        }
        return -1;
    }

    bool remove(int32_t id, double x, double y) {
        int32_t leaf = find_leaf(root, id, x, y);
        if (leaf < 0) return false;
        Node& nd = nodes[leaf];
        for (size_t i = 0; i < nd.ids.size(); i++) {
            if (nd.ids[i] == id && nd.xs[i] == x && nd.ys[i] == y) {
                nd.ids.erase(nd.ids.begin() + i);
                nd.xs.erase(nd.xs.begin() + i);
                nd.ys.erase(nd.ys.begin() + i);
                break;
            }
        }
        count--;
        // CondenseTree: collect orphaned points from underflowed nodes,
        // shrink ancestors, reinsert orphans
        std::vector<Entry> orphans;
        int32_t n = leaf;
        while (nodes[n].parent >= 0) {
            int32_t p = nodes[n].parent;
            if (nodes[n].size() < m) {
                // remove n from p; queue its points
                collect_points(n, orphans);
                auto& ch = nodes[p].child;
                ch.erase(std::find(ch.begin(), ch.end(), n));
            } else {
                recompute_mbr(n);
            }
            n = p;
        }
        recompute_mbr(root);
        // root with a single internal child shrinks
        while (!nodes[root].leaf && nodes[root].child.size() == 1) {
            root = nodes[root].child[0];
            nodes[root].parent = -1;
            height--;
        }
        if (!nodes[root].leaf && nodes[root].child.empty()) {
            nodes[root].leaf = true;
            nodes[root].mbr = Rect::empty();
            height = 1;
        }
        count -= orphans.size();
        for (auto& e : orphans) insert(e.id, e.x, e.y);
        return true;
    }

    void collect_points(int32_t n, std::vector<Entry>& out) {
        Node& nd = nodes[n];
        if (nd.leaf) {
            for (size_t i = 0; i < nd.ids.size(); i++)
                out.push_back({Rect{nd.xs[i], nd.ys[i], nd.xs[i], nd.ys[i]},
                               nd.ids[i], nd.xs[i], nd.ys[i]});
            return;
        }
        for (int32_t c : nd.child) collect_points(c, out);
    }

    void dwithin(double cx, double cy, double r,
                 std::vector<int32_t>& out) const {
        double r2 = r * r;
        std::vector<int32_t> stack{root};
        while (!stack.empty()) {
            int32_t n = stack.back();
            stack.pop_back();
            const Node& nd = nodes[n];
            if (!nd.mbr.intersects_circle(cx, cy, r)) continue;
            if (nd.leaf) {
                for (size_t i = 0; i < nd.ids.size(); i++) {
                    double dx = nd.xs[i] - cx, dy = nd.ys[i] - cy;
                    if (dx * dx + dy * dy <= r2) out.push_back(nd.ids[i]);
                }
            } else {
                for (int32_t c : nd.child) stack.push_back(c);
            }
        }
    }
};

void rtree_destroy(PyObject* cap) {
    delete (RTree*)PyCapsule_GetPointer(cap, "rtree");
}

RTree* unwrap(PyObject* cap) {
    return (RTree*)PyCapsule_GetPointer(cap, "rtree");
}

PyObject* rtree_new(PyObject*, PyObject* args) {
    int split_type;
    long max_entries;
    if (!PyArg_ParseTuple(args, "il", &split_type, &max_entries)) return nullptr;
    auto* t = new RTree(split_type, (size_t)max_entries);
    return PyCapsule_New(t, "rtree", rtree_destroy);
}

PyObject* rtree_insert(PyObject*, PyObject* args) {
    PyObject* cap;
    int id;
    double x, y;
    if (!PyArg_ParseTuple(args, "Oidd", &cap, &id, &x, &y)) return nullptr;
    unwrap(cap)->insert(id, x, y);
    Py_RETURN_NONE;
}

PyObject* rtree_remove(PyObject*, PyObject* args) {
    PyObject* cap;
    int id;
    double x, y;
    if (!PyArg_ParseTuple(args, "Oidd", &cap, &id, &x, &y)) return nullptr;
    if (unwrap(cap)->remove(id, x, y)) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

PyObject* rtree_dwithin(PyObject*, PyObject* args) {
    PyObject* cap;
    double x, y, dist;
    if (!PyArg_ParseTuple(args, "Oddd", &cap, &x, &y, &dist)) return nullptr;
    std::vector<int32_t> out;
    unwrap(cap)->dwithin(x, y, dist, out);
    return PyBytes_FromStringAndSize((const char*)out.data(),
                                     out.size() * 4);
}

PyObject* rtree_stats(PyObject*, PyObject* args) {
    PyObject* cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
    RTree* t = unwrap(cap);
    return Py_BuildValue("iln", t->height, (long)t->nodes.size(),
                         (Py_ssize_t)t->count);
}

PyMethodDef kMethods[] = {
    {"rtree_new", rtree_new, METH_VARARGS,
     "rtree_new(split_type, max_entries) -> capsule"},
    {"rtree_insert", rtree_insert, METH_VARARGS, "insert(cap, id, x, y)"},
    {"rtree_remove", rtree_remove, METH_VARARGS,
     "remove(cap, id, x, y) -> bool"},
    {"rtree_dwithin", rtree_dwithin, METH_VARARGS,
     "dwithin(cap, x, y, dist) -> bytes(i32 ids)"},
    {"rtree_stats", rtree_stats, METH_VARARGS,
     "stats(cap) -> (height, nodes, points)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "rtree_native",
                       "Guttman R-tree (4 split strategies)", -1, kMethods,
                       nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_rtree_native() { return PyModule_Create(&kModule); }
