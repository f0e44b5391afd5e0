// Incremental 2-D Delaunay triangulation (Bowyer–Watson with ghost
// triangles and walking point location).
//
// This is the framework's native graph construction: the one genuinely
// sequential, pointer-chasing stage of the pipeline (reference:
// flame::utils::Triangulator consumed at the `triangulate` engine stage,
// SURVEY §2.9) runs on the host in C++ while every numeric stage runs on
// device. It is called at poseframe rate only; the smoothing that consumes
// the produced edge list runs on-device every frame.
//
// Design: Shewchuk-style ghost triangles represent the region outside the
// convex hull, so insertion outside the hull is the same cavity operation
// as inside. Conflict tests use double-precision orient2d/incircle — the
// Python wrapper deterministically jitters (near-)grid inputs so exact
// arithmetic is not needed.
//
// C ABI (ctypes):
//   int delaunay_triangulate(const double* xy, int n,
//                            int* tris_out, int max_tris);
// Returns number of finite triangles written (3 ints each, CCW), or -1 on
// failure.

#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int GHOST = -1;

struct Tri {
  int v[3];    // vertex ids (GHOST allowed, at most one per triangle)
  int adj[3];  // adj[i] = neighbor opposite v[i] (-1 if none)
  bool alive;
};

struct Mesh {
  const double* xy;
  int n;
  std::vector<Tri> tris;
  std::vector<int> free_list;

  double px(int v) const { return xy[2 * v]; }
  double py(int v) const { return xy[2 * v + 1]; }

  int new_tri(int a, int b, int c) {
    int id;
    if (!free_list.empty()) {
      id = free_list.back();
      free_list.pop_back();
    } else {
      id = static_cast<int>(tris.size());
      tris.push_back(Tri());
    }
    Tri& t = tris[id];
    t.v[0] = a; t.v[1] = b; t.v[2] = c;
    t.adj[0] = t.adj[1] = t.adj[2] = -1;
    t.alive = true;
    return id;
  }

  void kill(int id) {
    tris[id].alive = false;
    free_list.push_back(id);
  }
};

inline double orient2d(double ax, double ay, double bx, double by,
                       double cx, double cy) {
  return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

inline double incircle(double ax, double ay, double bx, double by,
                       double cx, double cy, double dx, double dy) {
  const double adx = ax - dx, ady = ay - dy;
  const double bdx = bx - dx, bdy = by - dy;
  const double cdx = cx - dx, cdy = cy - dy;
  const double ad = adx * adx + ady * ady;
  const double bd = bdx * bdx + bdy * bdy;
  const double cd = cdx * cdx + cdy * cdy;
  return adx * (bdy * cd - bd * cdy) - ady * (bdx * cd - bd * cdx)
       + ad * (bdx * cdy - bdy * cdx);
}

// Does point p conflict with (lie in the circumdisk of) triangle t?
bool conflicts(const Mesh& m, int tid, double px, double py) {
  const Tri& t = m.tris[tid];
  int g = -1;
  for (int i = 0; i < 3; ++i)
    if (t.v[i] == GHOST) g = i;
  if (g < 0) {
    return incircle(m.px(t.v[0]), m.py(t.v[0]), m.px(t.v[1]), m.py(t.v[1]),
                    m.px(t.v[2]), m.py(t.v[2]), px, py) > 0.0;
  }
  // Ghost triangle (u, w, GHOST) stores the REVERSED hull edge (hull is
  // CCW w->u with interior on its left), so the ghost's outside region is
  // the open half-plane left of u->w. Collinear points count as conflicts
  // so on-hull points insert cleanly.
  const int u = t.v[(g + 1) % 3];
  const int w = t.v[(g + 2) % 3];
  const double o = orient2d(m.px(u), m.py(u), m.px(w), m.py(w), px, py);
  return o >= 0.0;
}

// Walking point location: returns a triangle in conflict with p, or -1.
int locate(const Mesh& m, int start, double px, double py) {
  int t = start;
  const int max_steps = static_cast<int>(m.tris.size()) * 2 + 64;
  for (int step = 0; step < max_steps && t >= 0; ++step) {
    if (!m.tris[t].alive) break;
    if (conflicts(m, t, px, py)) return t;
    const Tri& tr = m.tris[t];
    // Ghost that doesn't conflict: move inside across its finite edge.
    int g = -1;
    for (int i = 0; i < 3; ++i)
      if (tr.v[i] == GHOST) g = i;
    if (g >= 0) {
      t = tr.adj[g];
      continue;
    }
    // Finite triangle not containing p in its circumdisk: walk toward p
    // across an edge that separates p from the triangle.
    int next = -1;
    for (int i = 0; i < 3; ++i) {
      const int a = tr.v[(i + 1) % 3];
      const int b = tr.v[(i + 2) % 3];
      if (orient2d(m.px(a), m.py(a), m.px(b), m.py(b), px, py) < 0.0) {
        next = tr.adj[i];
        break;
      }
    }
    if (next < 0) {
      // Inside triangle but not in circumdisk cannot happen for Delaunay;
      // numerical edge case: fall through to scan.
      break;
    }
    t = next;
  }
  // Fallback: linear scan (robust, rare).
  for (int i = 0; i < static_cast<int>(m.tris.size()); ++i)
    if (m.tris[i].alive && conflicts(m, i, px, py)) return i;
  return -1;
}

struct EdgeKey {
  int a, b;
  bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};
struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    return std::hash<long long>()(
        (static_cast<long long>(k.a + 1) << 32) ^ (k.b + 1));
  }
};

// Insert point pid. Returns false on failure.
bool insert_point(Mesh& m, int pid, int& last_tri) {
  const double px = m.xy[2 * pid], py = m.xy[2 * pid + 1];
  int seed = locate(m, last_tri, px, py);
  if (seed < 0) return false;

  // BFS the connected conflict region.
  std::vector<int> cavity;
  std::vector<int> stack{seed};
  std::vector<char> in_cavity(m.tris.size(), 0);
  in_cavity[seed] = 1;
  while (!stack.empty()) {
    int t = stack.back();
    stack.pop_back();
    cavity.push_back(t);
    for (int i = 0; i < 3; ++i) {
      int nb = m.tris[t].adj[i];
      if (nb >= 0 && m.tris[nb].alive && !in_cavity[nb]
          && conflicts(m, nb, px, py)) {
        in_cavity[nb] = 1;
        stack.push_back(nb);
      }
    }
  }

  // Boundary edges: (u, w) of cavity triangle with neighbor outside.
  struct BEdge { int u, w, outside; };
  std::vector<BEdge> boundary;
  for (int t : cavity) {
    for (int i = 0; i < 3; ++i) {
      int nb = m.tris[t].adj[i];
      bool nb_in = nb >= 0 && nb < static_cast<int>(in_cavity.size())
                   && in_cavity[nb];
      if (!nb_in) {
        boundary.push_back({m.tris[t].v[(i + 1) % 3],
                            m.tris[t].v[(i + 2) % 3], nb});
      }
    }
  }
  if (boundary.empty()) return false;

  for (int t : cavity) m.kill(t);

  // Create fan of (u, w, p) triangles; stitch adjacency via edge map.
  std::unordered_map<EdgeKey, std::pair<int, int>, EdgeKeyHash> open_edges;
  int first_new = -1;
  for (const BEdge& be : boundary) {
    int nt = m.new_tri(be.u, be.w, pid);
    if (first_new < 0) first_new = nt;
    // adjacency across (u, w) -> outside triangle
    m.tris[nt].adj[2] = be.outside;
    if (be.outside >= 0) {
      Tri& ot = m.tris[be.outside];
      for (int i = 0; i < 3; ++i) {
        const int a = ot.v[(i + 1) % 3];
        const int b = ot.v[(i + 2) % 3];
        if ((a == be.w && b == be.u)) ot.adj[i] = nt;
      }
    }
    // Internal fan edges: (w, p) [opposite u, slot 0] and (p, u)
    // [opposite w, slot 1]. Match with sibling fan triangles.
    auto link = [&](int va, int vb, int slot) {
      EdgeKey key{std::min(va, vb), std::max(va, vb)};
      auto it = open_edges.find(key);
      if (it == open_edges.end()) {
        open_edges[key] = {nt, slot};
      } else {
        m.tris[nt].adj[slot] = it->second.first;
        m.tris[it->second.first].adj[it->second.second] = nt;
        open_edges.erase(it);
      }
    };
    link(be.w, pid, 0);
    link(pid, be.u, 1);
  }
  if (!open_edges.empty()) return false;  // cavity wasn't a closed star
  last_tri = first_new;
  return true;
}

}  // namespace

extern "C" int delaunay_triangulate(const double* xy, int n,
                                    int* tris_out, int max_tris) {
  if (n < 3) return 0;
  Mesh m;
  m.xy = xy;
  m.n = n;
  m.tris.reserve(4 * n + 16);

  // Initial triangle from points 0,1 and the first non-collinear k.
  int k = -1;
  double o = 0.0;
  for (int i = 2; i < n; ++i) {
    o = orient2d(xy[0], xy[1], xy[2], xy[3], xy[2 * i], xy[2 * i + 1]);
    if (std::fabs(o) > 1e-12) { k = i; break; }
  }
  if (k < 0) return 0;  // all collinear
  int a = 0, b = 1, c = k;
  if (o < 0) { b = k; c = 1; }  // make CCW

  const int t0 = m.new_tri(a, b, c);
  const int gab = m.new_tri(b, a, GHOST);
  const int gbc = m.new_tri(c, b, GHOST);
  const int gca = m.new_tri(a, c, GHOST);
  // t0 adjacency: opposite a is edge (b,c) -> gbc, etc.
  m.tris[t0].adj[0] = gbc;
  m.tris[t0].adj[1] = gca;
  m.tris[t0].adj[2] = gab;
  // Ghost (u, w, GHOST): slot2 (opposite GHOST) -> interior; slot0
  // (opposite u, edge (w, GHOST)) -> next ghost CW; slot1 (opposite w,
  // edge (GHOST, u)) -> prev ghost.
  auto link_ghosts = [&](int g_uw, int g_wx, int interior) {
    m.tris[g_uw].adj[2] = interior;
    m.tris[g_uw].adj[0] = g_wx;   // shares vertex w
    m.tris[g_wx].adj[1] = g_uw;
  };
  // Hull CCW is a->b->c; ghosts store reversed edges (b,a), (c,b), (a,c).
  // Ghost ring order: gab's w is a -> next ghost with u = a is gca? gca
  // stores (a, c): u = a. So gab -> gca -> gbc -> gab.
  link_ghosts(gab, gca, t0);
  link_ghosts(gca, gbc, t0);
  link_ghosts(gbc, gab, t0);

  int last = t0;
  for (int i = 2; i < n; ++i) {
    if (i == k) continue;
    if (!insert_point(m, i, last)) return -1;
  }

  int count = 0;
  for (const Tri& t : m.tris) {
    if (!t.alive) continue;
    if (t.v[0] == GHOST || t.v[1] == GHOST || t.v[2] == GHOST) continue;
    if (count >= max_tris) return -1;
    tris_out[3 * count] = t.v[0];
    tris_out[3 * count + 1] = t.v[1];
    tris_out[3 * count + 2] = t.v[2];
    ++count;
  }
  return count;
}
