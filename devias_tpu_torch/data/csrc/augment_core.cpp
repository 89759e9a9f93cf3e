// Host RandAugment core of devias_tpu_torch: a copy of the JAX package's
// native/augment_core.cpp (the code below is unchanged), so the port's
// training clips take the same arithmetic as the JAX package's.
//
// The hot primitives of RandAugment, in single-pass C++ over a whole uint8
// clip:
//
//   * truncating ITU-R 601-2 gray (PIL convert('L') semantics) and the
//     fused Color blend
//   * per-(frame, channel) histograms: AutoContrast's extrema and
//     Equalize's stepped LUT derive from them in Python (256 entries)
//   * per-frame per-channel LUT application
//   * PIL's Sharpness (SMOOTH filter, truncating blend, untouched border)
//   * 1-D cubic/linear inverse-map warps for ShearX/Y, TranslateX/Y:
//     these affines resample along ONE axis (the other coordinate maps to
//     the integer grid exactly, where the cubic kernel is the identity),
//     so 4 taps replace the 16-tap generic warp. The cubic kernel is PIL
//     Image.transform's a=-1.0 (cv2 uses a=-0.75) with PIL's
//     fill-iff-source-out-of-range edge rule.
//
// Layout: contiguous uint8 clips [T, H, W, 3]. All functions are plain C
// (ctypes binding in devias_tpu_torch/data/native_augment.py, which
// builds this file with g++ at first use).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---- truncating ITU-R 601-2 luma: (299 r + 587 g + 114 b) // 1000 -------
void devias_gray601(const uint8_t* rgb, uint8_t* out, int64_t npx) {
  for (int64_t i = 0; i < npx; ++i) {
    const uint8_t* p = rgb + 3 * i;
    out[i] = (uint8_t)((299u * p[0] + 587u * p[1] + 114u * p[2]) / 1000u);
  }
}

// ---- per-frame mean of the truncated gray (PIL ImageEnhance.Contrast) ---
void devias_gray_mean(const uint8_t* clip, int64_t t, int64_t hw,
                      double* means) {
  for (int64_t f = 0; f < t; ++f) {
    const uint8_t* p = clip + f * hw * 3;
    uint64_t acc = 0;
    for (int64_t i = 0; i < hw; ++i) {
      const uint8_t* px = p + 3 * i;
      acc += (299u * px[0] + 587u * px[1] + 114u * px[2]) / 1000u;
    }
    means[f] = (double)acc / (double)hw;
  }
}

// ---- per-(frame, channel) histograms: hist[t, c, v], uint32 -------------
void devias_hist(const uint8_t* clip, int64_t t, int64_t hw, uint32_t* hist) {
  memset(hist, 0, sizeof(uint32_t) * (size_t)t * 3 * 256);
  for (int64_t f = 0; f < t; ++f) {
    const uint8_t* p = clip + f * hw * 3;
    uint32_t* h = hist + f * 3 * 256;
    for (int64_t i = 0; i < hw; ++i) {
      ++h[0 * 256 + p[3 * i + 0]];
      ++h[1 * 256 + p[3 * i + 1]];
      ++h[2 * 256 + p[3 * i + 2]];
    }
  }
}

// ---- per-frame per-channel LUT: luts[t, c, v] ----------------------------
void devias_lut(const uint8_t* clip, const uint8_t* luts, uint8_t* out,
                int64_t t, int64_t hw) {
  for (int64_t f = 0; f < t; ++f) {
    const uint8_t* p = clip + f * hw * 3;
    const uint8_t* l = luts + f * 3 * 256;
    uint8_t* o = out + f * hw * 3;
    for (int64_t i = 0; i < hw; ++i) {
      o[3 * i + 0] = l[0 * 256 + p[3 * i + 0]];
      o[3 * i + 1] = l[1 * 256 + p[3 * i + 1]];
      o[3 * i + 2] = l[2 * 256 + p[3 * i + 2]];
    }
  }
}

// ---- fused Color: blend(gray3, rgb, f) — PIL out = g*(1-f) + c*f --------
// rint (round half to even) matches cv2.addWeighted's SIMD rounding, which
// the python fast path uses; PIL itself differs by <=1 level (tested).
void devias_color(const uint8_t* clip, uint8_t* out, int64_t npx, double f) {
  const float ff = (float)f;
  const float g0 = 1.0f - ff;
  for (int64_t i = 0; i < npx; ++i) {
    const uint8_t* p = clip + 3 * i;
    const float g =
        (float)((299u * p[0] + 587u * p[1] + 114u * p[2]) / 1000u) * g0;
    for (int c = 0; c < 3; ++c) {
      float v = nearbyintf(g + (float)p[c] * ff);
      out[3 * i + c] = (uint8_t)(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
    }
  }
}

// ---- fused Sharpness: blend(SMOOTH(clip), clip, f) ------------------------
// PIL ImageEnhance.Sharpness semantics, verified exact against Pillow:
//   * ImageFilter.SMOOTH: 3x3 kernel [[1,1,1],[1,5,1],[1,1,1]]/13, rounded
//     floor(v + 0.5) (== (2*conv + 13) / 26 in integers), 1-px border left
//     untouched
//   * Image.blend TRUNCATES: out = (uint8)(s + (p - s) * f), clipped to
//     [0, 255] only on the extrapolation path (f outside [0, 1]) — Pillow
//     Blend.c casts without rounding in both paths
// The border blends to the original exactly (blend(p, p, f) == p), so the
// frame is copied first and only the interior is recomputed. Replaces the
// python fast path's cv2.filter2D + 4 border fixups + cv2.addWeighted
// (3 passes; addWeighted also ROUNDS where PIL truncates).
void devias_sharpness(const uint8_t* in, uint8_t* out, int64_t t, int64_t h,
                      int64_t w, double f) {
  const float ff = (float)f;
  const int64_t stride = w * 3;
  for (int64_t fr = 0; fr < t; ++fr) {
    const uint8_t* fin = in + fr * h * stride;
    uint8_t* fout = out + fr * h * stride;
    memcpy(fout, fin, (size_t)h * stride);
    for (int64_t y = 1; y + 1 < h; ++y) {
      const uint8_t* r0 = fin + (y - 1) * stride;
      const uint8_t* r1 = fin + y * stride;
      const uint8_t* r2 = fin + (y + 1) * stride;
      uint8_t* o = fout + y * stride;
      for (int64_t j = 3; j + 3 < stride; ++j) {
        const uint32_t conv =
            (uint32_t)r0[j - 3] + r0[j] + r0[j + 3] +
            (uint32_t)r1[j - 3] + 5u * r1[j] + r1[j + 3] +
            (uint32_t)r2[j - 3] + r2[j] + r2[j + 3];
        const float sm = (float)((2u * conv + 13u) / 26u);
        const float v = sm + ((float)r1[j] - sm) * ff;
        const int iv = (int)v;  // trunc toward zero, like Pillow's cast
        o[j] = (uint8_t)(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
      }
    }
  }
}

// ---- 1-D inverse-map warps ------------------------------------------------
// Inverse-map convention (cv2 WARP_INVERSE_MAP / PIL Image.transform):
// output (x, y) samples input at the mapped coordinate. For the x-warp the
// map is src_x = x + shear * y + tx (src_y = y); for the y-warp
// src_y = y + shear * x + ty (src_x = x). y/x are frame-LOCAL.
//
// cubic: the cubic-convolution family at a = -1.0, PIL Image.transform's
// bicubic kernel (see cubic_w below). At integer offsets
// it is exactly (0, 1, 0, 0), which is what makes the 1-D form equal to
// the full 2-D warp for these matrices. interp[t]: 1 = cubic, 0 = linear
// (per-frame, for the reference's 'random' interpolation draw).

static inline void cubic_w(float fr, float* w) {
  // PIL Image.transform's bicubic kernel: the cubic family at a = -1.0
  // (NOT Catmull-Rom's -0.5, which PIL only uses for resize, and not
  // cv2's -0.75) — verified by impulse response against PIL AFFINE
  // transforms; weights at distances (1+fr, fr, 1-fr, 2-fr)
  const float a = -1.0f;
  float d;
  d = 1.0f + fr;
  w[0] = ((a * d - 5.0f * a) * d + 8.0f * a) * d - 4.0f * a;
  d = fr;
  w[1] = ((a + 2.0f) * d - (a + 3.0f)) * d * d + 1.0f;
  d = 1.0f - fr;
  w[2] = ((a + 2.0f) * d - (a + 3.0f)) * d * d + 1.0f;
  d = 2.0f - fr;
  w[3] = ((a * d - 5.0f * a) * d + 8.0f * a) * d - 4.0f * a;
}

static inline uint8_t clamp_round(float v) {
  v = nearbyintf(v);
  return (uint8_t)(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
}

void devias_warp_x(const uint8_t* in, uint8_t* out, int64_t t, int64_t h,
                   int64_t w, double shear, double tx, uint8_t fill,
                   const int32_t* interp) {
  for (int64_t f = 0; f < t; ++f) {
    const uint8_t* fin = in + f * h * w * 3;
    uint8_t* fout = out + f * h * w * 3;
    const int cubic = interp[f];
    for (int64_t y = 0; y < h; ++y) {
      const double k = shear * (double)y + tx;  // src_x = x + k
      const int64_t off = (int64_t)floor(k);
      const float fr = (float)(k - (double)off);
      float wgt[4] = {0, 0, 0, 0};
      int64_t first;  // leftmost tap relative to x
      int ntap;
      if (cubic) {
        cubic_w(fr, wgt);
        first = off - 1;
        ntap = 4;
      } else {
        wgt[0] = 1.0f - fr;
        wgt[1] = fr;
        first = off;
        ntap = 2;
      }
      const uint8_t* row = fin + y * w * 3;
      uint8_t* orow = fout + y * w * 3;
      // interior: all taps in range for x in [lo, hi)
      int64_t lo = -(first) > 0 ? -(first) : 0;                 // x + first >= 0
      int64_t hi = w - (first + ntap - 1);                      // x + first + ntap-1 <= w-1
      if (hi > w) hi = w;
      if (lo > w) lo = w;
      if (hi < lo) hi = lo;
      for (int64_t x = 0; x < lo; ++x) {
        // PIL edge rule: fill the pixel entirely when the source point is
        // outside [-0.5, w-0.5); otherwise interpolate with edge-CLAMPED
        // taps (verified against PIL AFFINE transforms)
        const double src = (double)x + k;
        if (src < -0.5 || src >= (double)w - 0.5) {
          orow[x * 3 + 0] = fill; orow[x * 3 + 1] = fill; orow[x * 3 + 2] = fill;
          continue;
        }
        float acc[3] = {0, 0, 0};
        for (int i = 0; i < ntap; ++i) {
          int64_t xs = x + first + i;
          if (xs < 0) xs = 0;
          if (xs >= w) xs = w - 1;
          const uint8_t* px = row + xs * 3;
          for (int c = 0; c < 3; ++c) acc[c] += wgt[i] * (float)px[c];
        }
        for (int c = 0; c < 3; ++c) orow[x * 3 + c] = clamp_round(acc[c]);
      }
      if (cubic) {
        const float w0 = wgt[0], w1 = wgt[1], w2 = wgt[2], w3 = wgt[3];
        const uint8_t* base = row + (lo + first) * 3;
        uint8_t* o = orow + lo * 3;
        const int64_t n = (hi - lo) * 3;  // channels are just 3 more lanes
        for (int64_t j = 0; j < n; ++j) {
          const float acc = w0 * (float)base[j] + w1 * (float)base[j + 3] +
                            w2 * (float)base[j + 6] + w3 * (float)base[j + 9];
          o[j] = clamp_round(acc);
        }
      } else {
        const float w0 = wgt[0], w1 = wgt[1];
        const uint8_t* base = row + (lo + first) * 3;
        uint8_t* o = orow + lo * 3;
        const int64_t n = (hi - lo) * 3;
        for (int64_t j = 0; j < n; ++j) {
          o[j] = clamp_round(w0 * (float)base[j] + w1 * (float)base[j + 3]);
        }
      }
      for (int64_t x = hi; x < w; ++x) {
        // PIL edge rule: fill the pixel entirely when the source point is
        // outside [-0.5, w-0.5); otherwise interpolate with edge-CLAMPED
        // taps (verified against PIL AFFINE transforms)
        const double src = (double)x + k;
        if (src < -0.5 || src >= (double)w - 0.5) {
          orow[x * 3 + 0] = fill; orow[x * 3 + 1] = fill; orow[x * 3 + 2] = fill;
          continue;
        }
        float acc[3] = {0, 0, 0};
        for (int i = 0; i < ntap; ++i) {
          int64_t xs = x + first + i;
          if (xs < 0) xs = 0;
          if (xs >= w) xs = w - 1;
          const uint8_t* px = row + xs * 3;
          for (int c = 0; c < 3; ++c) acc[c] += wgt[i] * (float)px[c];
        }
        for (int c = 0; c < 3; ++c) orow[x * 3 + c] = clamp_round(acc[c]);
      }
    }
  }
}

void devias_warp_y(const uint8_t* in, uint8_t* out, int64_t t, int64_t h,
                   int64_t w, double shear, double ty, uint8_t fill,
                   const int32_t* interp) {
  // per-column phase: precompute (first tap, weights) per x, then run rows
  // outer / columns inner so input reads stay row-contiguous per tap
  // shear == 0 (TranslateY): one phase for every column — a pure 4-tap
  // vertical convolution over contiguous rows, the autovectorizer's
  // favorite shape
  if (shear == 0.0) {
    const int64_t off0 = (int64_t)floor(ty);
    const float fr = (float)(ty - (double)off0);
    const int64_t stride = w * 3;
    for (int64_t f = 0; f < t; ++f) {
      const uint8_t* fin = in + f * h * stride;
      uint8_t* fout = out + f * h * stride;
      const int cubic = interp[f];
      float wv[4] = {0, 0, 0, 0};
      int64_t first0;
      int ntap;
      if (cubic) {
        cubic_w(fr, wv);
        first0 = off0 - 1;
        ntap = 4;
      } else {
        wv[0] = 1.0f - fr;
        wv[1] = fr;
        first0 = off0;
        ntap = 2;
      }
      for (int64_t y = 0; y < h; ++y) {
        uint8_t* orow = fout + y * stride;
        const int64_t y0 = y + first0;
        if (y0 >= 0 && y0 + ntap - 1 < h) {
          const uint8_t* p = fin + y0 * stride;
          if (cubic) {
            const float w0 = wv[0], w1 = wv[1], w2 = wv[2], w3 = wv[3];
            for (int64_t j = 0; j < stride; ++j) {
              orow[j] = clamp_round(
                  w0 * (float)p[j] + w1 * (float)p[stride + j] +
                  w2 * (float)p[2 * stride + j] + w3 * (float)p[3 * stride + j]);
            }
          } else {
            const float w0 = wv[0], w1 = wv[1];
            for (int64_t j = 0; j < stride; ++j) {
              orow[j] =
                  clamp_round(w0 * (float)p[j] + w1 * (float)p[stride + j]);
            }
          }
        } else {
          // PIL edge rule: fill the row entirely when the source point is
          // outside [-0.5, h-0.5); otherwise interpolate with edge-CLAMPED
          // taps (verified against PIL AFFINE transforms)
          const double src = (double)y + ty;
          if (src < -0.5 || src >= (double)h - 0.5) {
            memset(orow, fill, (size_t)stride);
            continue;
          }
          const uint8_t* rows[4];
          for (int i = 0; i < ntap; ++i) {
            int64_t ys = y0 + i;
            if (ys < 0) ys = 0;
            if (ys >= h) ys = h - 1;
            rows[i] = fin + ys * stride;
          }
          for (int64_t j = 0; j < stride; ++j) {
            float acc = 0.0f;
            for (int i = 0; i < ntap; ++i) acc += wv[i] * (float)rows[i][j];
            orow[j] = clamp_round(acc);
          }
        }
      }
    }
    return;
  }
  float* wgt = new float[(size_t)w * 4];
  int64_t* first = new int64_t[(size_t)w];
  // per-BYTE expanded weights + constant-`first` segment list: within a
  // segment the 2/4 source rows are fixed, so the interior loop becomes a
  // contiguous per-lane weighted row sum the autovectorizer handles —
  // same weights and add order as the per-column form (exactness tests
  // cover both shapes), ~3x faster at typical shear magnitudes
  float* wexp = new float[(size_t)w * 3 * 4];
  int64_t* seg = new int64_t[(size_t)w + 1];  // segment start columns
  for (int64_t f = 0; f < t; ++f) {
    const uint8_t* fin = in + f * h * w * 3;
    uint8_t* fout = out + f * h * w * 3;
    const int cubic = interp[f];
    const int ntap = cubic ? 4 : 2;
    int64_t fmin = 0, fmax = 0;  // range of `first` across columns
    for (int64_t x = 0; x < w; ++x) {
      const double k = shear * (double)x + ty;  // src_y = y + k
      const int64_t off = (int64_t)floor(k);
      const float fr = (float)(k - (double)off);
      if (cubic) {
        cubic_w(fr, wgt + x * 4);
        first[x] = off - 1;
      } else {
        wgt[x * 4 + 0] = 1.0f - fr;
        wgt[x * 4 + 1] = fr;
        wgt[x * 4 + 2] = 0.0f;
        wgt[x * 4 + 3] = 0.0f;
        first[x] = off;
      }
      if (x == 0 || first[x] < fmin) fmin = first[x];
      if (x == 0 || first[x] > fmax) fmax = first[x];
    }
    const int64_t stride = w * 3;
    int64_t nseg = 0;
    for (int64_t x = 0; x < w; ++x) {
      if (x == 0 || first[x] != first[x - 1]) seg[nseg++] = x;
      for (int i = 0; i < 4; ++i) {
        const float wv = wgt[x * 4 + i];
        wexp[i * stride + x * 3 + 0] = wv;
        wexp[i * stride + x * 3 + 1] = wv;
        wexp[i * stride + x * 3 + 2] = wv;
      }
    }
    seg[nseg] = w;
    for (int64_t y = 0; y < h; ++y) {
      uint8_t* orow = fout + y * w * 3;
      // interior row: EVERY column's taps are in range
      if (y + fmin >= 0 && y + fmax + ntap - 1 < h) {
        if (cubic) {
          for (int64_t s = 0; s < nseg; ++s) {
            const int64_t ja = seg[s] * 3, jb = seg[s + 1] * 3;
            const uint8_t* p = fin + (y + first[seg[s]]) * stride;
            const float* w0 = wexp, *w1 = wexp + stride,
                       * w2 = wexp + 2 * stride, *w3 = wexp + 3 * stride;
            for (int64_t j = ja; j < jb; ++j) {
              const float acc = w0[j] * (float)p[j] +
                                w1[j] * (float)p[stride + j] +
                                w2[j] * (float)p[2 * stride + j] +
                                w3[j] * (float)p[3 * stride + j];
              orow[j] = clamp_round(acc);
            }
          }
        } else {
          for (int64_t s = 0; s < nseg; ++s) {
            const int64_t ja = seg[s] * 3, jb = seg[s + 1] * 3;
            const uint8_t* p = fin + (y + first[seg[s]]) * stride;
            const float* w0 = wexp, *w1 = wexp + stride;
            for (int64_t j = ja; j < jb; ++j) {
              orow[j] = clamp_round(w0[j] * (float)p[j] +
                                    w1[j] * (float)p[stride + j]);
            }
          }
        }
        continue;
      }
      for (int64_t x = 0; x < w; ++x) {
        // PIL edge rule: fill the pixel entirely when the source point is
        // outside [-0.5, h-0.5); otherwise interpolate with edge-CLAMPED
        // taps (verified against PIL AFFINE transforms)
        const double src = (double)y + shear * (double)x + ty;
        if (src < -0.5 || src >= (double)h - 0.5) {
          orow[x * 3 + 0] = fill; orow[x * 3 + 1] = fill; orow[x * 3 + 2] = fill;
          continue;
        }
        const float* wx = wgt + x * 4;
        const int64_t y0 = y + first[x];
        float acc[3] = {0, 0, 0};
        for (int i = 0; i < ntap; ++i) {
          int64_t ys = y0 + i;
          if (ys < 0) ys = 0;
          if (ys >= h) ys = h - 1;
          const uint8_t* px = fin + (ys * w + x) * 3;
          for (int c = 0; c < 3; ++c) acc[c] += wx[i] * (float)px[c];
        }
        for (int c = 0; c < 3; ++c) orow[x * 3 + c] = clamp_round(acc[c]);
      }
    }
  }
  delete[] wgt;
  delete[] first;
  delete[] wexp;
  delete[] seg;
}

}  // extern "C"
