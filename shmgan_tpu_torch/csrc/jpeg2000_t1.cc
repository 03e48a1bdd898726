// JPEG 2000 tier 1 (ITU-T T.800 Annex C and D): the MQ decoder, the raw
// decoder of selective bypass, and the significance-propagation,
// magnitude-refinement and cleanup passes of a batch of code-blocks, every
// code-block style of Part 1 (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM),
// as openjpeg's t1.c decodes them. The counterpart of data/jpeg2000.py's
// t1_block_plain, which it repeats bit for bit: coefficients at twice their
// scale, the last decoded bit-plane's mid-point included, negative where the
// sign bit is set.
//
//   int shm_j2k_t1_decode(const char* data, const int64_t* data_off,
//                         const int32_t* params, const int32_t* segs, int nsegs,
//                         const int64_t* out_off, int32_t* out, int n)
//
// Block i reads data[data_off[i] .. data_off[i + 1]) and writes params[8i + 1]
// rows of params[8i] int32 coefficients at out + out_off[i]; params[8i + 2]
// is its sub-band (0 LL, 1 HL, 2 LH, 3 HH), params[8i + 3] its coded
// bit-planes, params[8i + 4] its RGN shift (bit-planes above them),
// params[8i + 5] its code-block style, and its codeword segments are the
// params[8i + 7] pairs (passes, bytes) of segs from pair params[8i + 6] on,
// their bytes one after another. Blocks go to kThreads threads. Returns 0,
// or 1 + the first block whose parameters are out of range (nothing is
// written for it).

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

  void reset() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[0] = 4;
    state[kCtxRl] = 3;
    state[kCtxUni] = 46;
  }

  // a codeword segment, MQ-coded (INITDEC) or raw (selective bypass)
  void init(const uint8_t* data, int64_t n, bool raw) {
    d = data;
    len = n;
    bp = 0;
    if (raw) {
      c = 0;
      ct = 0;
      return;
    }
    c = static_cast<uint32_t>(at(0)) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int raw() {  // opj_mqc_raw_decode
    if (ct == 0) {
      if (c == 0xFF && at(bp) > 0x8F) {
        ct = 8;
      } else {
        ct = c == 0xFF ? 7 : 8;
        c = at(bp++);
      }
    }
    --ct;
    return (c >> ct) & 1;
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

constexpr int kBypass = 0x01, kReset = 0x02, kVsc = 0x08, kSegsym = 0x20;

struct Block {
  int w, h, S;
  bool vsc;
  std::vector<uint8_t> sig, neg, pi, refined;
  std::vector<int32_t> mag;
  const uint8_t* zc;
  Mq mq;

  // `cut`: the row below the stripe counts as insignificant (VSC)
  int context(int p, bool cut) const {
    const uint8_t* s = sig.data();
    int below = cut ? 0 : 5 * s[p + S] + s[p + S - 1] + s[p + S + 1];
    return zc[15 * (s[p - 1] + s[p + 1]) + 5 * s[p - S] + below + s[p - S - 1] + s[p - S + 1]];
  }

  int contribution(int p) const { return sig[p] ? (neg[p] ? -1 : 1) : 0; }

  int sign(int p, bool cut) {
    int hc = std::clamp(contribution(p - 1) + contribution(p + 1), -1, 1);
    int vc = std::clamp(contribution(p - S) + (cut ? 0 : contribution(p + S)), -1, 1);
    int i = 3 * (hc + 1) + vc + 1;
    return mq.decode(kScCtx[i]) ^ kScXor[i];
  }

  void significant(int p, int32_t oph, bool cut) {
    neg[p] = static_cast<uint8_t>(sign(p, cut));
    mag[p] = oph;
    sig[p] = 1;
  }

  bool any_neighbour(int p0) const {
    for (int k = -1; k < (vsc ? 4 : 5); ++k) {
      int p = p0 + k * S;
      if (sig[p - 1] | sig[p] | sig[p + 1]) return true;
    }
    return false;
  }

  void sigpass(int32_t oph, bool raw) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int p = (y0 + 1) * S + x + 1;
        for (int k = 0; k < std::min(4, h - y0); ++k, p += S) {
          if (sig[p]) continue;
          bool cut = vsc && k == 3;
          int ctx = context(p, cut);
          if (!ctx) continue;
          pi[p] = 1;
          if (raw) {
            if (mq.raw()) {
              neg[p] = static_cast<uint8_t>(mq.raw());
              mag[p] = oph;
              sig[p] = 1;
            }
          } else if (mq.decode(ctx)) {
            significant(p, oph, cut);
          }
        }
      }
  }

  void refpass(int32_t half, bool raw) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int p = (y0 + 1) * S + x + 1;
        for (int k = 0; k < std::min(4, h - y0); ++k, p += S) {
          if (!sig[p] || pi[p]) continue;
          int bit;
          if (raw) {
            bit = mq.raw();
          } else {
            int ctx;
            if (refined[p]) {
              ctx = 16;
            } else {
              const uint8_t* s = sig.data();
              int around = s[p - 1] | s[p + 1] | s[p - S] | s[p - S - 1] | s[p - S + 1];
              if (!(vsc && k == 3)) around |= s[p + S] | s[p + S - 1] | s[p + S + 1];
              ctx = around ? 15 : 14;
            }
            bit = mq.decode(ctx);
          }
          mag[p] += bit ? half : -half;
          refined[p] = 1;
        }
      }
  }

  void cleanup(int32_t oph, bool segsym) {
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
          significant(p0 + k * S, oph, vsc && k == 3);
          start = k + 1;
        }
        for (int k = start; k < rows; ++k) {
          int p = p0 + k * S;
          bool cut = vsc && k == 3;
          if (!sig[p] && !pi[p] && mq.decode(context(p, cut))) significant(p, oph, cut);
        }
      }
    }
    std::fill(pi.begin(), pi.end(), 0);
    if (segsym)
      for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
  }

  void run(const uint8_t* data, const int32_t* segs, int nsegs, int orient, int numbps,
           int roishift, int style, int32_t* out) {
    S = w + 2;
    size_t n = static_cast<size_t>(S) * (h + 2);
    sig.assign(n, 0);
    neg.assign(n, 0);
    pi.assign(n, 0);
    refined.assign(n, 0);
    mag.assign(n, 0);
    zc = kZc.t[orient];
    vsc = style & kVsc;
    mq.reset();
    int bpno = numbps + roishift, kind = 2;  // openjpeg's bpno_plus_one; a cleanup first
    for (int s = 0; s < nsegs; ++s) {
      bool raw = (style & kBypass) && kind < 2 && bpno <= numbps - 4;
      mq.init(data, segs[2 * s + 1], raw);
      data += segs[2 * s + 1];
      for (int i = 0; i < segs[2 * s] && bpno >= 1; ++i) {
        int bp = bpno - 1;
        if (kind == 0) sigpass(3 << bp, raw);
        else if (kind == 1) refpass(1 << bp, raw);
        else cleanup(3 << bp, style & kSegsym);
        if ((style & kReset) && !raw) mq.reset();
        if (++kind == 3) {
          kind = 0;
          --bpno;
        }
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
                                 const int32_t* params, const int32_t* segs, int nsegs,
                                 const int64_t* out_off, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    const int32_t* p = params + 8 * i;
    if (p[0] < 0 || p[1] < 0 || p[0] > 1024 || p[1] > 1024 || p[0] * p[1] > 4096 ||
        p[2] < 0 || p[2] > 3 || p[4] < 0 || p[3] + p[4] > 30 || (p[5] & ~0x3F) ||
        p[6] < 0 || p[7] < 0 || p[6] > nsegs - p[7])
      return i + 1;
    int64_t bytes = 0;
    for (int s = p[6]; s < p[6] + p[7]; ++s) {
      if (segs[2 * s] < 0 || segs[2 * s + 1] < 0) return i + 1;
      bytes += segs[2 * s + 1];
    }
    if (bytes != data_off[i + 1] - data_off[i]) return i + 1;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    Block blk;
    for (int i; (i = next.fetch_add(1)) < n;) {
      const int32_t* p = params + 8 * i;
      if (p[0] == 0 || p[1] == 0 || p[7] == 0) {
        std::fill(out + out_off[i], out + out_off[i] + static_cast<int64_t>(p[0]) * p[1], 0);
        continue;
      }
      blk.w = p[0];
      blk.h = p[1];
      blk.run(reinterpret_cast<const uint8_t*>(data) + data_off[i], segs + 2 * p[6], p[7], p[2],
              p[3], p[4], p[5], out + out_off[i]);
    }
  };
  int threads = std::max(1, std::min(kThreads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();
  return 0;
}
