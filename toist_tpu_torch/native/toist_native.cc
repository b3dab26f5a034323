// toist_native — C++ core for the TPU-native TOIST framework.
//
// Implements the native components the reference delegates to third-party
// packages (SURVEY.md §2.3):
//   * LAPJV-style exact linear sum assignment (reference uses
//     scipy.optimize.linear_sum_assignment, models/matcher.py:85)
//   * COCO run-length-encoding core: encode/decode/area/iou/merge, the
//     compressed char-string codec, and polygon rasterization (reference uses
//     pycocotools._mask, datasets/tdod.py:136, datasets/coco_eval.py:272)
//   * byte-level BPE encoding with character offsets (reference uses the HF
//     Rust tokenizer, models/transformer.py:59; char offsets feed the
//     positive-map machinery, datasets/tdod.py:150-176)
//
// Everything is exposed through a C ABI consumed via ctypes (no pybind11 in
// this image). All implementations are from published format/algorithm specs,
// not translations of the reference.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC toist_native.cc -o libtoist_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Linear sum assignment (shortest augmenting path with dual potentials).
// cost: row-major [nr, nc] with nr <= nc. col4row: [nr] output (column chosen
// for each row). Returns 0 on success, -1 on infeasible/invalid input.
// ---------------------------------------------------------------------------
int lsa_solve(const double* cost, int nr, int nc, int* col4row) {
  if (nr > nc || nr < 0) return -1;
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(nr, 0.0), v(nc, 0.0), shortest(nc);
  std::vector<int> row4col(nc, -1), path(nc, -1);
  std::vector<char> SR(nr), SC(nc);
  std::fill(col4row, col4row + nr, -1);

  for (int cur = 0; cur < nr; ++cur) {
    std::fill(SR.begin(), SR.end(), 0);
    std::fill(SC.begin(), SC.end(), 0);
    std::fill(shortest.begin(), shortest.end(), INF);
    std::fill(path.begin(), path.end(), -1);
    double minval = 0.0;
    int i = cur, sink = -1;
    while (sink == -1) {
      SR[i] = 1;
      const double* ci = cost + (size_t)i * nc;
      double lowest = INF;
      int jlow = -1;
      for (int j = 0; j < nc; ++j) {
        if (SC[j]) continue;
        double r = minval + ci[j] - u[i] - v[j];
        if (r < shortest[j]) { shortest[j] = r; path[j] = i; }
        if (shortest[j] < lowest ||
            (shortest[j] == lowest && jlow >= 0 && row4col[j] == -1 &&
             row4col[jlow] != -1)) {
          lowest = shortest[j];
          jlow = j;
        }
      }
      if (jlow < 0 || lowest == INF) return -1;  // infeasible
      minval = lowest;
      SC[jlow] = 1;
      if (row4col[jlow] == -1) sink = jlow; else i = row4col[jlow];
    }
    u[cur] += minval;
    for (int r = 0; r < nr; ++r)
      if (SR[r] && r != cur) u[r] += minval - shortest[col4row[r]];
    for (int j = 0; j < nc; ++j)
      if (SC[j]) v[j] -= minval - shortest[j];
    // Augment backwards from sink.
    int j = sink;
    while (true) {
      int r = path[j];
      row4col[j] = r;
      int prev = col4row[r];
      col4row[r] = j;
      if (r == cur) break;
      j = prev;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// COCO RLE. Masks are column-major (Fortran) uint8 arrays of shape [h, w],
// flattened index = x * h + y, per the COCO mask format. Counts alternate
// runs of 0s and 1s, starting with 0s.
// ---------------------------------------------------------------------------

// Encode binary mask -> counts. Returns number of counts written (caller
// provides counts buffer of size h*w+1).
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts) {
  int64_t n = (int64_t)h * w;
  int m = 0;
  uint8_t prev = 0;
  uint32_t c = 0;
  for (int64_t k = 0; k < n; ++k) {
    uint8_t cur = mask[k] ? 1 : 0;
    if (cur != prev) { counts[m++] = c; c = 0; prev = cur; }
    ++c;
  }
  counts[m++] = c;
  return m;
}

// Encode a column-major BIT-PACKED mask -> counts. The device mask
// postprocess (models/postprocess.py) emits masks as [n_cols, col_bytes]
// with 8 rows per byte, MSB-first (np.unpackbits order), columns padded to
// the canvas height; col_stride is the byte stride between columns and oh
// the number of valid bits per column. Column-major bit order IS COCO's
// Fortran-order RLE stream, so runs are accumulated straight off the packed
// bytes (0x00/0xFF fast paths) with no unpack or transpose — the host cost
// that dominated segmentation eval otherwise (2.2s/batch measured, r3).
extern "C" int rle_encode_packed_cm(const uint8_t* base, int col_stride,
                                    int oh, int ow, uint32_t* counts) {
  int m = 0;
  uint8_t cur = 0;
  uint32_t run = 0;
  const int full_bytes = oh >> 3, tail = oh & 7;
  for (int x = 0; x < ow; ++x) {
    const uint8_t* col = base + (size_t)x * col_stride;
    for (int i = 0; i < full_bytes; ++i) {
      uint8_t b = col[i];
      if (b == 0) {
        if (cur == 0) run += 8;
        else { counts[m++] = run; cur = 0; run = 8; }
      } else if (b == 0xFF) {
        if (cur == 1) run += 8;
        else { counts[m++] = run; cur = 1; run = 8; }
      } else {
        for (int k = 7; k >= 0; --k) {
          uint8_t bit = (b >> k) & 1;
          if (bit == cur) ++run;
          else { counts[m++] = run; cur = bit; run = 1; }
        }
      }
    }
    if (tail) {
      uint8_t b = col[full_bytes];
      for (int k = 7; k > 7 - tail; --k) {
        uint8_t bit = (b >> k) & 1;
        if (bit == cur) ++run;
        else { counts[m++] = run; cur = bit; run = 1; }
      }
    }
  }
  counts[m++] = run;
  return m;
}

// Decode counts -> binary mask (caller zeroes/allocates h*w bytes).
void rle_decode(const uint32_t* counts, int m, int h, int w, uint8_t* mask) {
  int64_t k = 0, n = (int64_t)h * w;
  uint8_t val = 0;
  for (int i = 0; i < m; ++i) {
    uint32_t c = counts[i];
    for (uint32_t j = 0; j < c && k < n; ++j) mask[k++] = val;
    val = 1 - val;
  }
}

uint64_t rle_area(const uint32_t* counts, int m) {
  uint64_t a = 0;
  for (int i = 1; i < m; i += 2) a += counts[i];
  return a;
}

// Area of intersection of two RLEs over the same canvas.
static uint64_t rle_intersect_area(const uint32_t* a, int ma,
                                   const uint32_t* b, int mb) {
  uint64_t inter = 0;
  int ia = 0, ib = 0;
  uint64_t ca = ia < ma ? a[ia] : 0, cb = ib < mb ? b[ib] : 0;
  uint8_t va = 0, vb = 0;
  while (ia < ma && ib < mb) {
    uint64_t step = std::min(ca, cb);
    if (va && vb) inter += step;
    ca -= step; cb -= step;
    if (ca == 0) { ++ia; va = 1 - va; ca = ia < ma ? a[ia] : 0; }
    if (cb == 0) { ++ib; vb = 1 - vb; cb = ib < mb ? b[ib] : 0; }
  }
  return inter;
}

// IoU between RLE dt and gt. iscrowd: union is dt's area (COCO convention).
double rle_iou(const uint32_t* dt, int mdt, const uint32_t* gt, int mgt,
               int iscrowd) {
  uint64_t inter = rle_intersect_area(dt, mdt, gt, mgt);
  uint64_t adt = rle_area(dt, mdt), agt = rle_area(gt, mgt);
  double uni = iscrowd ? (double)adt : (double)(adt + agt - inter);
  if (uni <= 0) return 0.0;
  return (double)inter / uni;
}

// Merge (union or intersection) of two RLEs -> counts. Returns m of output.
int rle_merge(const uint32_t* a, int ma, const uint32_t* b, int mb,
              int intersect, uint32_t* out) {
  int ia = 0, ib = 0, mo = 0;
  uint64_t ca = ia < ma ? a[ia] : 0, cb = ib < mb ? b[ib] : 0;
  uint8_t va = 0, vb = 0, prev = 0;
  uint64_t run = 0;
  while (ia < ma && ib < mb) {
    uint64_t step = std::min(ca, cb);
    uint8_t v = intersect ? (va & vb) : (va | vb);
    if (v == prev) run += step;
    else { out[mo++] = (uint32_t)run; run = step; prev = v; }
    ca -= step; cb -= step;
    if (ca == 0) { ++ia; va = 1 - va; ca = ia < ma ? a[ia] : 0; }
    if (cb == 0) { ++ib; vb = 1 - vb; cb = ib < mb ? b[ib] : 0; }
  }
  out[mo++] = (uint32_t)run;
  return mo;
}

// Compressed char-string codec (the COCO "counts" string format): each count
// is delta-coded against counts[i-2] and emitted as little-endian 5-bit
// chunks with a continuation bit, chars offset by 48.
int rle_to_string(const uint32_t* counts, int m, char* out /*>=m*7+1*/) {
  int p = 0;
  for (int i = 0; i < m; ++i) {
    int64_t x = (int64_t)counts[i];
    if (i > 2) x -= (int64_t)counts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[p++] = (char)(c + 48);
    }
  }
  out[p] = 0;
  return p;
}

int rle_from_string(const char* s, uint32_t* counts, int max_m) {
  int m = 0, p = 0;
  while (s[p]) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      int64_t c = (int64_t)s[p] - 48;
      if (s[p] == 0) return -1;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++p; ++k;
      if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
    }
    if (m > 2) x += (int64_t)counts[m - 2];
    if (m >= max_m || x < 0) return -1;
    counts[m++] = (uint32_t)x;
  }
  return m;
}

// ---------------------------------------------------------------------------
// COCO evaluation greedy matching (the inner loop of COCOeval.evaluateImg).
// For each IoU threshold t and each score-sorted detection d, find the best
// still-unmatched (or crowd) gt with iou >= t, preferring non-ignored gts.
// ious: [D, G] row-major. gt_ignore/iscrowd: [G]. thrs: [T].
// Outputs (caller-allocated): dtm [T, D] (matched gt index +1, 0 = unmatched),
// dt_ignore [T, D] (0/1), gtm [T, G] (matched dt index +1).
// ---------------------------------------------------------------------------
void coco_match(const double* ious, int D, int G, const uint8_t* gt_ignore,
                const uint8_t* iscrowd, const double* thrs, int T,
                int32_t* dtm, uint8_t* dt_ignore, int32_t* gtm) {
  for (int t = 0; t < T; ++t) {
    int32_t* dtm_t = dtm + (size_t)t * D;
    uint8_t* dti_t = dt_ignore + (size_t)t * D;
    int32_t* gtm_t = gtm + (size_t)t * G;
    for (int g = 0; g < G; ++g) gtm_t[g] = 0;
    for (int d = 0; d < D; ++d) {
      double iou_best = thrs[t] < (1 - 1e-10) ? thrs[t] : (1 - 1e-10);
      int m = -1;
      const double* iou_d = ious + (size_t)d * G;
      for (int g = 0; g < G; ++g) {
        if (gtm_t[g] > 0 && !iscrowd[g]) continue;
        // Best remaining gts are ignored and we already matched a non-ignored
        // one: stop (gt list is sorted non-ignored first).
        if (m > -1 && !gt_ignore[m] && gt_ignore[g]) break;
        if (iou_d[g] < iou_best) continue;
        iou_best = iou_d[g];
        m = g;
      }
      if (m == -1) { dtm_t[d] = 0; dti_t[d] = 0; continue; }
      dti_t[d] = gt_ignore[m];
      dtm_t[d] = m + 1;
      gtm_t[m] = d + 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Polygon -> mask rasterization (even-odd rule sampled at pixel centers,
// 5x supersampled boundary handling via center-point test).
// xy: flat [x0,y0,x1,y1,...] of k vertices. Writes into mask (column-major,
// caller-zeroed) with OR semantics so multiple polygons union together.
// Note: this is a standard even-odd center-sample fill; pycocotools' rleFrPoly
// uses an upsampled boundary walk whose boundary pixels can differ by <=1px.
// GT and predictions both go through this rasterizer, so eval is
// self-consistent (documented divergence: SURVEY.md §2.3).
// ---------------------------------------------------------------------------
void poly_to_mask(const double* xy, int k, int h, int w, uint8_t* mask) {
  if (k < 3) return;
  std::vector<double> xs(k), ys(k);
  double ymin = 1e30, ymax = -1e30;
  for (int i = 0; i < k; ++i) {
    xs[i] = xy[2 * i];
    ys[i] = xy[2 * i + 1];
    ymin = std::min(ymin, ys[i]);
    ymax = std::max(ymax, ys[i]);
  }
  int y0 = std::max(0, (int)std::floor(ymin));
  int y1 = std::min(h - 1, (int)std::ceil(ymax));
  std::vector<double> nodes;
  for (int y = y0; y <= y1; ++y) {
    double yc = y + 0.5;
    nodes.clear();
    for (int i = 0, j = k - 1; i < k; j = i++) {
      double yi = ys[i], yj = ys[j];
      if ((yi <= yc && yj > yc) || (yj <= yc && yi > yc)) {
        double x = xs[i] + (yc - yi) / (yj - yi) * (xs[j] - xs[i]);
        nodes.push_back(x);
      }
    }
    std::sort(nodes.begin(), nodes.end());
    for (size_t t = 0; t + 1 < nodes.size(); t += 2) {
      int xa = std::max(0, (int)std::ceil(nodes[t] - 0.5));
      int xb = std::min(w - 1, (int)std::floor(nodes[t + 1] - 0.5));
      for (int x = xa; x <= xb; ++x) mask[(size_t)x * h + y] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Byte-level BPE with character offsets.
//
// The tokenizer object is created from vocab (token -> id, newline-separated
// "token\tid") and merges ("left right" per line, rank = line order). Encoding
// follows GPT-2/RoBERTa byte-level BPE over a Unicode-aware pre-tokenizer
// (letter/number runs classified via the generated L/N category tables in
// unicode_tables.inc, punctuation, contractions, leading space) and
// returns per-token ids plus [start,end) character offsets with leading
// whitespace trimmed (RoBERTa's trim_offsets=True behavior), so that
// char_to_token(space) misses, matching the reference's probing fallbacks
// (datasets/tdod.py:155-170).
// ---------------------------------------------------------------------------

namespace {

struct BPE {
  std::unordered_map<std::string, int> vocab;
  std::map<std::pair<std::string, std::string>, int> merge_rank;
  int unk_id = 3;
};

std::vector<BPE*> g_bpes;

// GPT-2 byte -> printable unicode char mapping (as UTF-8 strings).
std::string byte_to_unicode(uint8_t b) {
  // printable ASCII + latin-1 ranges map to themselves; the rest shift by 256.
  int cp;
  if ((b >= 33 && b <= 126) || (b >= 161 && b <= 172) || (b >= 174 && b <= 255))
    cp = b;
  else {
    // assign in order: bytes not in the ranges above get 256+n
    static std::vector<int> table = [] {
      std::vector<int> t(256, -1);
      int n = 0;
      for (int i = 0; i < 256; ++i) {
        bool keep = (i >= 33 && i <= 126) || (i >= 161 && i <= 172) ||
                    (i >= 174 && i <= 255);
        if (keep) t[i] = i;
        else t[i] = 256 + n++;
      }
      return t;
    }();
    cp = table[b];
  }
  // UTF-8 encode codepoint.
  std::string s;
  if (cp < 0x80) s += (char)cp;
  else if (cp < 0x800) {
    s += (char)(0xC0 | (cp >> 6));
    s += (char)(0x80 | (cp & 0x3F));
  } else {
    s += (char)(0xE0 | (cp >> 12));
    s += (char)(0x80 | ((cp >> 6) & 0x3F));
    s += (char)(0x80 | (cp & 0x3F));
  }
  return s;
}

// Unicode \p{L} / \p{N} classification over UTF-8 codepoints (full category
// tables generated from unicodedata; see unicode_tables.inc). This matches the
// GPT-2/RoBERTa pre-tokenizer regex classes for arbitrary text, not just the
// ASCII captions (parity-tested vs HF tokenizers in tests/test_tokenizer_parity.py).
#include "unicode_tables.inc"

bool cp_in_ranges(uint32_t cp, const uint32_t (*ranges)[2], int n) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < ranges[mid][0]) hi = mid - 1;
    else if (cp > ranges[mid][1]) lo = mid + 1;
    else return true;
  }
  return false;
}

bool cp_is_letter(uint32_t cp) {
  return cp_in_ranges(cp, kLetterRanges,
                      (int)(sizeof(kLetterRanges) / sizeof(kLetterRanges[0])));
}
bool cp_is_digit(uint32_t cp) {
  return cp_in_ranges(cp, kNumberRanges,
                      (int)(sizeof(kNumberRanges) / sizeof(kNumberRanges[0])));
}
bool cp_is_space(uint32_t cp) {
  // Python regex \s (unicode): ASCII whitespace + Unicode space separators.
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == 0x0B ||
         cp == 0x0C || cp == 0x1C || cp == 0x1D || cp == 0x1E || cp == 0x1F ||
         cp == 0x85 || cp == 0xA0 || cp == 0x1680 ||
         (cp >= 0x2000 && cp <= 0x200A) || cp == 0x2028 || cp == 0x2029 ||
         cp == 0x202F || cp == 0x205F || cp == 0x3000;
}

// Decode the UTF-8 codepoint at byte offset i; *len gets the byte length.
// Invalid sequences decode as single bytes (byte-level BPE tolerates them).
uint32_t decode_utf8(const std::string& s, int i, int* len) {
  uint8_t c = (uint8_t)s[i];
  int n = (int)s.size();
  if (c < 0x80) { *len = 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < n) {
    *len = 2;
    return ((c & 0x1F) << 6) | ((uint8_t)s[i + 1] & 0x3F);
  }
  if ((c >> 4) == 0xE && i + 2 < n) {
    *len = 3;
    return ((c & 0x0F) << 12) | (((uint8_t)s[i + 1] & 0x3F) << 6) |
           ((uint8_t)s[i + 2] & 0x3F);
  }
  if ((c >> 3) == 0x1E && i + 3 < n) {
    *len = 4;
    return ((c & 0x07) << 18) | (((uint8_t)s[i + 1] & 0x3F) << 12) |
           (((uint8_t)s[i + 2] & 0x3F) << 6) | ((uint8_t)s[i + 3] & 0x3F);
  }
  *len = 1;
  return c;
}

bool is_space(char c) { return c == ' ' || c == '\t' || c == '\n' || c == '\r'; }

// Pre-tokenize UTF-8 text following the GPT-2 pattern:
// 's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
// Emits [start, end) BYTE spans (leading space included in the span).
void pretokenize(const std::string& text,
                 std::vector<std::pair<int, int>>* spans) {
  int n = (int)text.size(), i = 0;
  int cl = 0;  // codepoint byte length scratch
  while (i < n) {
    int start = i;
    // contractions (lowercase-only, like the GPT-2 regex literals)
    if (text[i] == '\'' && i + 1 < n) {
      auto try_suffix = [&](const char* sfx) {
        int len = (int)strlen(sfx);
        if (i + len <= n && strncmp(text.c_str() + i, sfx, len) == 0) {
          spans->emplace_back(i, i + len);
          i += len;
          return true;
        }
        return false;
      };
      if (try_suffix("'re") || try_suffix("'ve") || try_suffix("'ll") ||
          try_suffix("'s") || try_suffix("'t") || try_suffix("'m") ||
          try_suffix("'d"))
        continue;
    }
    int j = i;
    uint32_t c = decode_utf8(text, j, &cl);
    bool lead_space = false;
    if (c == ' ' && j + 1 < n) {
      int nl;
      uint32_t nc = decode_utf8(text, j + 1, &nl);
      if (!cp_is_space(nc)) {
        lead_space = true;
        j += 1;
        c = decode_utf8(text, j, &cl);
      }
    }
    if (cp_is_letter(c)) {
      int kk = j;
      while (kk < n) {
        uint32_t cc = decode_utf8(text, kk, &cl);
        if (!cp_is_letter(cc)) break;
        kk += cl;
      }
      spans->emplace_back(start, kk);
      i = kk;
    } else if (cp_is_digit(c)) {
      int kk = j;
      while (kk < n) {
        uint32_t cc = decode_utf8(text, kk, &cl);
        if (!cp_is_digit(cc)) break;
        kk += cl;
      }
      spans->emplace_back(start, kk);
      i = kk;
    } else if (cp_is_space(c) && !lead_space) {
      // Whitespace run; \s+(?!\S) keeps the last space attached to a following
      // non-space token.
      int kk = i;
      int last_start = i, last_len = 0;
      while (kk < n) {
        uint32_t cc = decode_utf8(text, kk, &cl);
        if (!cp_is_space(cc)) break;
        last_start = kk;
        last_len = cl;
        kk += cl;
      }
      if (kk < n && last_start > i)
        kk = last_start;  // \s+(?!\S): leave the final whitespace char for the
                          // next token's ` ?` prefix (or its own \s+ match)
      (void)last_len;
      if (kk == i) kk = i + cl;
      spans->emplace_back(i, kk);
      i = kk;
    } else {
      int kk = j;
      while (kk < n) {
        uint32_t cc = decode_utf8(text, kk, &cl);
        if (cp_is_space(cc) || cp_is_letter(cc) || cp_is_digit(cc)) break;
        kk += cl;
      }
      spans->emplace_back(start, kk);
      i = kk;
    }
  }
}

}  // namespace

// Create tokenizer from vocab + merges strings. Returns handle (>=0).
int bpe_create(const char* vocab_txt, const char* merges_txt, int unk_id) {
  BPE* bpe = new BPE();
  bpe->unk_id = unk_id;
  {
    const char* p = vocab_txt;
    while (*p) {
      const char* tab = strchr(p, '\t');
      if (!tab) break;
      const char* nl = strchr(tab, '\n');
      if (!nl) nl = tab + strlen(tab);
      std::string tok(p, tab - p);
      int id = atoi(std::string(tab + 1, nl - tab - 1).c_str());
      bpe->vocab[tok] = id;
      p = (*nl) ? nl + 1 : nl;
    }
  }
  {
    const char* p = merges_txt;
    int rank = 0;
    while (*p) {
      const char* nl = strchr(p, '\n');
      if (!nl) nl = p + strlen(p);
      std::string line(p, nl - p);
      size_t sp = line.find(' ');
      if (sp != std::string::npos && !line.empty() && line[0] != '#') {
        bpe->merge_rank[{line.substr(0, sp), line.substr(sp + 1)}] = rank++;
      }
      p = (*nl) ? nl + 1 : nl;
    }
  }
  g_bpes.push_back(bpe);
  return (int)g_bpes.size() - 1;
}

void bpe_free(int handle) {
  if (handle >= 0 && handle < (int)g_bpes.size() && g_bpes[handle]) {
    delete g_bpes[handle];
    g_bpes[handle] = nullptr;
  }
}

// Encode text. Outputs ids and char offsets [start,end) per token (leading
// whitespace trimmed from offsets). Returns token count, or -1 on error.
int bpe_encode(int handle, const char* text_c, int* ids, int* starts,
               int* ends, int max_tokens) {
  if (handle < 0 || handle >= (int)g_bpes.size() || !g_bpes[handle]) return -1;
  const BPE& bpe = *g_bpes[handle];
  std::string text(text_c);
  std::vector<std::pair<int, int>> spans;
  pretokenize(text, &spans);

  int nt = 0;
  for (auto& sp : spans) {
    int start = sp.first, end = sp.second;
    // Byte-level symbols for this pre-token, one per input byte.
    std::vector<std::string> syms;
    std::vector<int> sym_start, sym_end;  // char offsets per symbol
    for (int i = start; i < end; ++i) {
      syms.push_back(byte_to_unicode((uint8_t)text[i]));
      sym_start.push_back(i);
      sym_end.push_back(i + 1);
    }
    // Greedy lowest-rank merge loop.
    while (syms.size() > 1) {
      int best = std::numeric_limits<int>::max(), bi = -1;
      for (size_t i = 0; i + 1 < syms.size(); ++i) {
        auto it = bpe.merge_rank.find({syms[i], syms[i + 1]});
        if (it != bpe.merge_rank.end() && it->second < best) {
          best = it->second;
          bi = (int)i;
        }
      }
      if (bi < 0) break;
      syms[bi] += syms[bi + 1];
      sym_end[bi] = sym_end[bi + 1];
      syms.erase(syms.begin() + bi + 1);
      sym_start.erase(sym_start.begin() + bi + 1);
      sym_end.erase(sym_end.begin() + bi + 1);
    }
    for (size_t i = 0; i < syms.size(); ++i) {
      if (nt >= max_tokens) return nt;
      auto it = bpe.vocab.find(syms[i]);
      ids[nt] = (it != bpe.vocab.end()) ? it->second : bpe.unk_id;
      // Offset trimming (RoBERTa trim_offsets=True): HF's ByteLevel
      // post-processor strips the space byte 0x20 ('Ġ') from BOTH ends of
      // each token's offsets — other whitespace (tab etc.) is kept, and a
      // pure-space token collapses to an empty (end, end) span.
      int s = sym_start[i], e = sym_end[i];
      while (s < e && text[s] == ' ') ++s;
      while (e > s && text[e - 1] == ' ') --e;
      starts[nt] = s;
      ends[nt] = e;
      ++nt;
    }
  }
  return nt;
}

}  // extern "C"
