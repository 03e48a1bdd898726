// JPEG 2000 tier 1 (ITU-T T.800 Annex C and D) for code-block style 0: the
// MQ decoder and the significance-propagation, magnitude-refinement and
// cleanup passes of a batch of code-blocks, as openjpeg's t1.c decodes them.
// The counterpart of data/jpeg2000.py's t1_block_plain, which it repeats bit
// for bit: coefficients at twice their scale, the last decoded bit-plane's
// mid-point included, negative where the sign bit is set.
//
//   int shm_j2k_t1_decode(const char* data, const int64_t* data_off,
//                         const int32_t* params, const int64_t* out_off,
//                         int32_t* out, int n)
//
// Block i reads data[data_off[i] .. data_off[i] + params[6i + 5]) and writes
// params[6i + 1] rows of params[6i] int32 coefficients at out + out_off[i];
// params[6i + 2] is its sub-band (0 LL, 1 HL, 2 LH, 3 HH), params[6i + 3]
// its coded bit-planes, params[6i + 4] its coding passes. Blocks go to
// kThreads threads. Returns 0, or 1 + the first block whose parameters
// are out of range (nothing is written for it).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// the code-blocks of an image are shared among this many threads
constexpr int kThreads = 4;

struct Qe {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};

// T.800 Table C.2
const Qe kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

constexpr int kCtxRl = 17, kCtxUni = 18;

// T.800 Table D.1: zero-coding context of (h, v, d) at 15h + 5v + d
struct ZcTables {
  uint8_t t[4][45];
  ZcTables() {
    for (int o = 0; o < 4; ++o)
      for (int h = 0; h < 3; ++h)
        for (int v = 0; v < 3; ++v)
          for (int d = 0; d < 5; ++d) {
            int ctx;
            if (o == 3) {
              int hv = h + v;
              if (d >= 3) ctx = 8;
              else if (d == 2) ctx = hv ? 7 : 6;
              else if (d == 1) ctx = hv >= 2 ? 5 : (hv ? 4 : 3);
              else ctx = hv >= 2 ? 2 : hv;
            } else {
              int a = o == 1 ? v : h, b = o == 1 ? h : v;  // HL swaps h and v
              if (a == 2) ctx = 8;
              else if (a == 1) ctx = b ? 7 : (d ? 6 : 5);
              else if (b == 2) ctx = 4;
              else if (b == 1) ctx = 3;
              else ctx = d >= 2 ? 2 : d;
            }
            t[o][15 * h + 5 * v + d] = static_cast<uint8_t>(ctx);
          }
  }
};
const ZcTables kZc;

// T.800 Table D.3: (context, XOR bit) at 3 (H + 1) + V + 1
const uint8_t kScCtx[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
const uint8_t kScXor[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

struct Mq {
  const uint8_t* d;
  int64_t len, bp;
  uint32_t a, c;
  int ct;
  uint8_t state[19], mps[19];

  uint8_t at(int64_t i) const { return i < len ? d[i] : 0xFF; }  // two 0xFF past the end

  void bytein() {
    if (at(bp) == 0xFF) {
      if (at(bp + 1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(at(bp)) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(at(bp)) << 8;
      ct = 8;
    }
  }

  void init(const uint8_t* data, int64_t n) {
    d = data;
    len = n;
    bp = 0;
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[0] = 4;
    state[kCtxRl] = 3;
    state[kCtxUni] = 46;
    c = static_cast<uint32_t>(at(0)) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int decode(int cx) {
    const Qe& q = kMq[state[cx]];
    int dbit;
    a -= q.qe;
    if ((c >> 16) < q.qe) {
      if (a < q.qe) {
        dbit = mps[cx];
        state[cx] = q.nmps;
      } else {
        dbit = 1 - mps[cx];
        if (q.sw) mps[cx] = static_cast<uint8_t>(dbit);
        state[cx] = q.nlps;
      }
      a = q.qe;
    } else {
      c -= q.qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < q.qe) {
        dbit = 1 - mps[cx];
        if (q.sw) mps[cx] = static_cast<uint8_t>(dbit);
        state[cx] = q.nlps;
      } else {
        dbit = mps[cx];
        state[cx] = q.nmps;
      }
    }
    do {  // RENORMD
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
    return dbit;
  }
};

struct Block {
  int w, h, S;
  std::vector<uint8_t> sig, neg, pi, refined;
  std::vector<int32_t> mag;
  const uint8_t* zc;
  Mq mq;

  int context(int p) const {
    const uint8_t* s = sig.data();
    return zc[15 * (s[p - 1] + s[p + 1]) + 5 * (s[p - S] + s[p + S]) + s[p - S - 1] +
              s[p - S + 1] + s[p + S - 1] + s[p + S + 1]];
  }

  int contribution(int p) const { return sig[p] ? (neg[p] ? -1 : 1) : 0; }

  int sign(int p) {
    int hc = std::clamp(contribution(p - 1) + contribution(p + 1), -1, 1);
    int vc = std::clamp(contribution(p - S) + contribution(p + S), -1, 1);
    int i = 3 * (hc + 1) + vc + 1;
    return mq.decode(kScCtx[i]) ^ kScXor[i];
  }

  void significant(int p, int32_t oph) {
    neg[p] = static_cast<uint8_t>(sign(p));
    mag[p] = oph;
    sig[p] = 1;
  }

  bool any_neighbour(int p0) const {
    for (int k = -1; k < 5; ++k) {
      int p = p0 + k * S;
      if (sig[p - 1] | sig[p] | sig[p + 1]) return true;
    }
    return false;
  }

  void sigpass(int32_t oph) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int p = (y0 + 1) * S + x + 1;
        for (int k = 0; k < std::min(4, h - y0); ++k, p += S) {
          if (sig[p]) continue;
          int ctx = context(p);
          if (!ctx) continue;
          pi[p] = 1;
          if (mq.decode(ctx)) significant(p, oph);
        }
      }
  }

  void refpass(int32_t half) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int p = (y0 + 1) * S + x + 1;
        for (int k = 0; k < std::min(4, h - y0); ++k, p += S) {
          if (!sig[p] || pi[p]) continue;
          int ctx;
          if (refined[p]) {
            ctx = 16;
          } else {
            const uint8_t* s = sig.data();
            ctx = (s[p - 1] | s[p + 1] | s[p - S] | s[p + S] | s[p - S - 1] | s[p - S + 1] |
                   s[p + S - 1] | s[p + S + 1])
                      ? 15
                      : 14;
          }
          mag[p] += mq.decode(ctx) ? half : -half;
          refined[p] = 1;
        }
      }
  }

  void cleanup(int32_t oph) {
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = std::min(4, h - y0);
      for (int x = 0; x < w; ++x) {
        int p0 = (y0 + 1) * S + x + 1;
        int start = 0;
        if (rows == 4 &&
            !(pi[p0] | pi[p0 + S] | pi[p0 + 2 * S] | pi[p0 + 3 * S] || any_neighbour(p0))) {
          if (!mq.decode(kCtxRl)) continue;
          int k = mq.decode(kCtxUni) << 1;
          k |= mq.decode(kCtxUni);
          significant(p0 + k * S, oph);
          start = k + 1;
        }
        for (int k = start; k < rows; ++k) {
          int p = p0 + k * S;
          if (!sig[p] && !pi[p] && mq.decode(context(p))) significant(p, oph);
        }
      }
    }
    std::fill(pi.begin(), pi.end(), 0);
  }

  void run(const uint8_t* data, int64_t len, int orient, int numbps, int passes,
           int32_t* out) {
    S = w + 2;
    size_t n = static_cast<size_t>(S) * (h + 2);
    sig.assign(n, 0);
    neg.assign(n, 0);
    pi.assign(n, 0);
    refined.assign(n, 0);
    mag.assign(n, 0);
    zc = kZc.t[orient];
    mq.init(data, len);
    int bp = numbps - 1, kind = 2;  // the first pass is a cleanup
    for (int i = 0; i < passes && bp >= 0; ++i) {
      int32_t oph = 3 << bp;
      if (kind == 0) sigpass(oph);
      else if (kind == 1) refpass(1 << bp);
      else cleanup(oph);
      if (++kind == 3) {
        kind = 0;
        --bp;
      }
    }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        int p = (y + 1) * S + x + 1;
        out[static_cast<int64_t>(y) * w + x] = neg[p] ? -mag[p] : mag[p];
      }
  }
};

}  // namespace

extern "C" int shm_j2k_t1_decode(const char* data, const int64_t* data_off,
                                 const int32_t* params, const int64_t* out_off, int32_t* out,
                                 int n) {
  for (int i = 0; i < n; ++i) {
    const int32_t* p = params + 6 * i;
    if (p[0] < 0 || p[1] < 0 || p[0] > 1024 || p[1] > 1024 || p[0] * p[1] > 4096 ||
        p[2] < 0 || p[2] > 3 || p[3] > 30 || p[4] < 0 || p[5] < 0)
      return i + 1;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    Block blk;
    for (int i; (i = next.fetch_add(1)) < n;) {
      const int32_t* p = params + 6 * i;
      if (p[0] == 0 || p[1] == 0 || p[4] == 0 || p[3] <= 0) {
        std::fill(out + out_off[i], out + out_off[i] + static_cast<int64_t>(p[0]) * p[1], 0);
        continue;
      }
      blk.w = p[0];
      blk.h = p[1];
      blk.run(reinterpret_cast<const uint8_t*>(data) + data_off[i], p[5], p[2], p[3], p[4],
              out + out_off[i]);
    }
  };
  int threads = std::max(1, std::min(kThreads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return 0;
}
