// roadsurf_native: C++ data-plane kernels for the road weather framework.
//
// The reference implements its data plane in C++ (examples/example1/src/
// JsonSource.cpp interpolation loops, examples/example2/src/AsciiSource.cpp
// fixed-column parsing, WorkQueue.h thread pool).  This library provides the
// same ingest hot paths as columnar batch operations callable from Python via
// ctypes, multithreaded over stations with a bounded work queue.
//
// Build: make -C native    (produces libroadsurf_native.so)
//
// Exposed C ABI:
//   rs_interpolate_columns : per-station time interpolation to the sim grid
//                            (semantics of JsonSource.cpp:49-176)
//   rs_parse_ascii_obs     : fixed-column ASCII obs rows -> epoch + columns
//                            (AsciiSource.cpp row format)
//   rs_grid_at_points      : missing-aware bilinear / nearest-valid-corner
//                            extraction of [R, ny, nx] grids at P points
//                            (QueryDataSource.cpp:931 InterpolatedValue)
//   rs_version             : ABI version tag

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr double kMissing = -9999.9;

// ---------------------------------------------------------------------------
// Bounded work queue (cf. examples/example1/src/WorkQueue.h:15-131): N worker
// threads consume station tasks; the producer blocks when the queue is full.
// ---------------------------------------------------------------------------
class WorkQueue {
 public:
  explicit WorkQueue(int workers) : stop_(false) {
    if (workers <= 0) workers = (int)std::thread::hardware_concurrency();
    for (int i = 0; i < workers; ++i)
      threads_.emplace_back([this] { this->run(); });
  }
  ~WorkQueue() { join_all(); }

  void submit(std::function<void()> task) {
    std::unique_lock<std::mutex> lk(m_);
    cv_space_.wait(lk, [this] { return q_.size() < 2 * threads_.size(); });
    q_.push(std::move(task));
    cv_work_.notify_one();
  }

  void join_all() {
    {
      std::unique_lock<std::mutex> lk(m_);
      stop_ = true;
      cv_work_.notify_all();
    }
    for (auto& t : threads_)
      if (t.joinable()) t.join();
    threads_.clear();
  }

 private:
  void run() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_work_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (q_.empty()) {
          if (stop_) return;
          continue;
        }
        task = std::move(q_.front());
        q_.pop();
        cv_space_.notify_one();
      }
      task();
    }
  }

  std::mutex m_;
  std::condition_variable cv_work_, cv_space_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> threads_;
  bool stop_;
};

// ---------------------------------------------------------------------------
// Interpolation core for one variable of one station; replicates
// JsonSource.cpp:49-176 (exact-match copy, both-endpoints-valid linear).
// ---------------------------------------------------------------------------
void interp_one(const int64_t* raw_t, int64_t nraw, const int64_t* sim_t,
                int64_t nsim, const double* vals, double miss_thresh,
                int nearest_next, double* out) {
  for (int64_t s = 0; s < nsim; ++s) out[s] = kMissing;
  if (nraw == 0) return;
  int64_t raw_pos = 0;
  int64_t sim_pos = 0;
  if (raw_t[0] < sim_t[0]) {
    while (raw_pos < nraw && raw_t[raw_pos] < sim_t[0]) ++raw_pos;
    if (raw_pos > 0) --raw_pos;
  } else if (sim_t[0] < raw_t[0]) {
    while (sim_pos < nsim && sim_t[sim_pos] < raw_t[0]) ++sim_pos;
  }
  while (raw_pos + 1 < nraw && sim_pos < nsim) {
    const int64_t ts = sim_t[sim_pos];
    if (ts == raw_t[raw_pos]) {
      if (vals[raw_pos] > miss_thresh) out[sim_pos] = vals[raw_pos];
      ++sim_pos;
    } else if (ts == raw_t[raw_pos + 1]) {
      ++raw_pos;
    } else if (ts > raw_t[raw_pos] && ts < raw_t[raw_pos + 1]) {
      if (nearest_next) {
        if (vals[raw_pos + 1] > miss_thresh) out[sim_pos] = vals[raw_pos + 1];
      } else if (vals[raw_pos] > miss_thresh &&
                 vals[raw_pos + 1] > miss_thresh) {
        const double w =
            double(ts - raw_t[raw_pos]) /
            double(raw_t[raw_pos + 1] - raw_t[raw_pos]);
        out[sim_pos] = vals[raw_pos] + w * (vals[raw_pos + 1] - vals[raw_pos]);
      }
      ++sim_pos;
    } else if (ts < raw_t[raw_pos]) {
      ++sim_pos;
    } else {
      ++raw_pos;
    }
  }
  // trailing exact match at the final raw sample
  while (sim_pos < nsim) {
    if (sim_t[sim_pos] == raw_t[nraw - 1] && vals[nraw - 1] > miss_thresh)
      out[sim_pos] = vals[nraw - 1];
    ++sim_pos;
  }
}

}  // namespace

extern "C" {

int rs_version() { return 2; }

// Batched interpolation over stations x variables.
//
// station_offsets: [nstations+1] prefix offsets into raw_times/values rows;
// raw_times:       [total_raw] epochs (per station, ascending);
// sim_times:       [nsim] epochs;
// values:          [nvars][total_raw] row-major variable data;
// miss_thresh:     [nvars] per-variable missing threshold (-100 / -1000);
// nearest_next:    [nvars] 1 = PrecPhase-style nearest-next;
// out:             [nstations][nvars][nsim] row-major;
// nthreads:        worker threads (<=0: hardware concurrency).
void rs_interpolate_columns(const int64_t* station_offsets, int64_t nstations,
                            const int64_t* raw_times, const int64_t* sim_times,
                            int64_t nsim, const double* values, int64_t nvars,
                            int64_t total_raw, const double* miss_thresh,
                            const int32_t* nearest_next, double* out,
                            int32_t nthreads) {
  WorkQueue queue(nthreads);
  for (int64_t st = 0; st < nstations; ++st) {
    queue.submit([=] {
      const int64_t beg = station_offsets[st];
      const int64_t end = station_offsets[st + 1];
      const int64_t nraw = end - beg;
      for (int64_t v = 0; v < nvars; ++v) {
        interp_one(raw_times + beg, nraw, sim_times, nsim,
                   values + v * total_raw + beg, miss_thresh[v],
                   nearest_next[v], out + (st * nvars + v) * nsim);
      }
    });
  }
  queue.join_all();
}

// Fixed-column ASCII observation parser (examples/example2/src/AsciiSource.cpp
// row format: yy mm dd hh tair rh vz rr1h rform srad lrad tsurf).
//
// text/nbytes: file contents; out_epoch [max_rows]; out_vals [8][max_rows]
// (tair, rh, vz, rr1h, rform, srad, lrad, tsurf).  Returns rows parsed.
int64_t rs_parse_ascii_obs(const char* text, int64_t nbytes,
                           int64_t* out_epoch, double* out_vals,
                           int64_t max_rows) {
  int64_t row = 0;
  const char* p = text;
  const char* endp = text + nbytes;
  auto skip_ws = [&] {
    while (p < endp && (*p == ' ' || *p == '\t')) ++p;
  };
  auto read_num = [&](double* x) -> bool {
    skip_ws();
    char* np = nullptr;
    double v = strtod(p, &np);
    if (np == p) return false;
    p = np;
    *x = v;
    return true;
  };
  while (p < endp && row < max_rows) {
    // skip empty / comment lines
    skip_ws();
    if (p < endp && (*p == '\n' || *p == '\r')) {
      ++p;
      continue;
    }
    if (p < endp && *p == '#') {
      while (p < endp && *p != '\n') ++p;
      continue;
    }
    double f[12];
    bool ok = true;
    for (int k = 0; k < 12; ++k)
      if (!read_num(&f[k])) {
        ok = false;
        break;
      }
    while (p < endp && *p != '\n') ++p;  // to end of line
    if (!ok) continue;
    int year = (int)f[0];
    if (year < 100) year += 2000;
    const int mon = (int)f[1], day = (int)f[2], hour = (int)f[3];
    // days since epoch (civil date algorithm)
    const int y = year - (mon <= 2 ? 1 : 0);
    const int era = (y >= 0 ? y : y - 399) / 400;
    const unsigned yoe = (unsigned)(y - era * 400);
    const unsigned doy = (153u * (mon + (mon > 2 ? -3 : 9)) + 2) / 5 + day - 1;
    const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    const int64_t days = (int64_t)era * 146097 + (int64_t)doe - 719468;
    out_epoch[row] = days * 86400 + (int64_t)hour * 3600;
    for (int k = 0; k < 8; ++k) out_vals[k * max_rows + row] = f[4 + k];
    ++row;
  }
  return row;
}

// Gridded-field extraction at points: missing-aware bilinear (mode 0,
// corner weights renormalized over valid corners) or nearest-valid-corner
// (mode 1, categorical fields; largest weight wins, ties in corner order).
// Mirrors io/gridsource.py bilinear_at_points / nearest_corner_at_points
// expression-for-expression so both paths agree bitwise in float64.
//
// field: [R, ny, nx] row-major; lats [ny] ASCENDING (flip_y=1 means the
// caller's grid was descending and row i maps to ny-1-i); lons [nx]
// ascending; plat/plon [P]; out: [P, R] row-major.  Missing = NaN or
// <= -9000; missing output = -9999.9.
void rs_grid_at_points(const double* field, int64_t R, int64_t ny, int64_t nx,
                       const double* lats, const double* lons,
                       const double* plat, const double* plon, int64_t P,
                       int32_t flip_y, int32_t mode, double* out,
                       int32_t nthreads) {
  const double* la = lats;
  const double* lo = lons;
  auto missing = [](double v) { return std::isnan(v) || v <= -9000.0; };
  const int64_t blk = 8192;
  WorkQueue queue(nthreads);
  for (int64_t b0 = 0; b0 < P; b0 += blk) {
    const int64_t b1 = std::min(P, b0 + blk);
    queue.submit([=] {
      std::vector<int64_t> iy(b1 - b0), ix(b1 - b0);
      std::vector<double> fy(b1 - b0), fx(b1 - b0);
      std::vector<char> inside(b1 - b0);
      for (int64_t p = b0; p < b1; ++p) {
        // searchsorted(side='right') - 1, clipped to [0, n-2]
        const double y = plat[p], x = plon[p];
        int64_t jy = (int64_t)(std::upper_bound(la, la + ny, y) - la) - 1;
        int64_t jx = (int64_t)(std::upper_bound(lo, lo + nx, x) - lo) - 1;
        jy = std::max<int64_t>(0, std::min<int64_t>(jy, ny - 2));
        jx = std::max<int64_t>(0, std::min<int64_t>(jx, nx - 2));
        // degenerate 1-row/1-column grids: the +1 neighbor does not exist;
        // collapse the weight to 0 and read the same cell (matches the
        // numpy fallback, whose negative-index wrap lands on the same row)
        const double dy = (jy + 1 < ny) ? la[jy + 1] - la[jy] : 0.0;
        const double dx = (jx + 1 < nx) ? lo[jx + 1] - lo[jx] : 0.0;
        iy[p - b0] = jy;
        ix[p - b0] = jx;
        fy[p - b0] = dy > 0 ? (y - la[jy]) / dy : 0.0;
        fx[p - b0] = dx > 0 ? (x - lo[jx]) / dx : 0.0;
        inside[p - b0] =
            (y >= la[0] && y <= la[ny - 1] && x >= lo[0] && x <= lo[nx - 1]);
      }
      for (int64_t r = 0; r < R; ++r) {
        const double* f = field + r * ny * nx;
        for (int64_t p = b0; p < b1; ++p) {
          const int64_t i = p - b0;
          const int64_t jy = iy[i], jx = ix[i];
          const double wy = fy[i], wx = fx[i];
          const double w[4] = {(1 - wy) * (1 - wx), (1 - wy) * wx,
                               wy * (1 - wx), wy * wx};
          double v[4];
          for (int c = 0; c < 4; ++c) {
            int64_t ry = std::min<int64_t>(jy + (c >> 1), ny - 1);
            int64_t rx = std::min<int64_t>(jx + (c & 1), nx - 1);
            if (flip_y) ry = ny - 1 - ry;
            v[c] = f[ry * nx + rx];
          }
          double res = kMissing;
          if (mode == 0) {
            double acc = 0.0, wsum = 0.0;
            for (int c = 0; c < 4; ++c)
              if (!missing(v[c])) {
                acc += v[c] * w[c];
                wsum += w[c];
              }
            if (wsum > 1e-12 && inside[i]) res = acc / wsum;
          } else {
            double bw = -1.0;
            for (int c = 0; c < 4; ++c)
              if (!missing(v[c]) && w[c] > bw) {
                bw = w[c];
                res = v[c];
              }
            if (!inside[i]) res = kMissing;
          }
          out[p * R + r] = res;
        }
      }
    });
  }
  queue.join_all();
}

}  // extern "C"
