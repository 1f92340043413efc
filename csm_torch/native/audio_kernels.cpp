// Native audio-loader kernels for the csm_torch data pipeline.
//
// The training data path decodes + resamples hours of WAV audio per run
// (the original CSM trained on ~1M hours — docs/reference/sesame_csm/
// training.md); this keeps the host-side loader off the Python
// interpreter: WAV parsing with mono mixdown and a polyphase FIR
// resampler, both single-pass over contiguous buffers.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
// Built by csm_torch/native/__init__.py (g++ into build/native/).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// ---- WAV parsing (RIFF PCM 8/16/24/32-bit + float32) ----

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;        // 8/16/24/32
  int32_t is_float;    // 1 for IEEE float data
  int64_t n_frames;    // per-channel sample count
  int64_t data_offset; // byte offset of PCM payload
};

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Returns 0 on success, negative error codes otherwise.
int csm_wav_info(const uint8_t* data, int64_t n, WavInfo* out) {
  if (n < 44 || memcmp(data, "RIFF", 4) || memcmp(data + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int have_fmt = 0;
  WavInfo info;
  memset(&info, 0, sizeof(info));
  while (pos + 8 <= n) {
    const uint8_t* chunk = data + pos;
    uint32_t size = rd_u32(chunk + 4);
    if (!memcmp(chunk, "fmt ", 4)) {
      if (pos + 8 + 16 > n) return -2;
      uint16_t fmt = rd_u16(chunk + 8);
      info.channels = rd_u16(chunk + 10);
      info.sample_rate = (int32_t)rd_u32(chunk + 12);
      info.bits = rd_u16(chunk + 22);
      if (fmt == 3) info.is_float = 1;
      else if (fmt != 1 && fmt != 0xFFFE) return -3; // PCM / extensible only
      have_fmt = 1;
    } else if (!memcmp(chunk, "data", 4)) {
      if (!have_fmt || info.channels <= 0 || info.bits <= 0) return -4;
      int64_t payload = size;
      if (pos + 8 + payload > n) payload = n - pos - 8; // tolerate truncation
      info.data_offset = pos + 8;
      info.n_frames = payload / (info.channels * (info.bits / 8));
      *out = info;
      return 0;
    }
    pos += 8 + size + (size & 1); // chunks are 2-byte aligned
  }
  return -5;
}

// Decode to mono float32 in [-1, 1] (channel average). `out` must hold
// n_frames floats. Returns 0 on success.
int csm_wav_decode(const uint8_t* data, int64_t n, float* out) {
  WavInfo info;
  int rc = csm_wav_info(data, n, &info);
  if (rc) return rc;
  const uint8_t* p = data + info.data_offset;
  const int C = info.channels;
  const double inv_c = 1.0 / C;
  if (info.is_float && info.bits == 32) {
    const float* f = (const float*)p;
    for (int64_t i = 0; i < info.n_frames; i++) {
      double acc = 0;
      for (int c = 0; c < C; c++) acc += f[i * C + c];
      out[i] = (float)(acc * inv_c);
    }
  } else if (info.bits == 16) {
    const double s = inv_c / 32768.0;
    for (int64_t i = 0; i < info.n_frames; i++) {
      double acc = 0;
      for (int c = 0; c < C; c++)
        acc += (int16_t)rd_u16(p + (i * C + c) * 2);
      out[i] = (float)(acc * s);
    }
  } else if (info.bits == 8) { // unsigned
    const double s = inv_c / 128.0;
    for (int64_t i = 0; i < info.n_frames; i++) {
      double acc = 0;
      for (int c = 0; c < C; c++) acc += (int)p[i * C + c] - 128;
      out[i] = (float)(acc * s);
    }
  } else if (info.bits == 24) {
    const double s = inv_c / 8388608.0;
    for (int64_t i = 0; i < info.n_frames; i++) {
      double acc = 0;
      for (int c = 0; c < C; c++) {
        const uint8_t* b = p + (i * C + c) * 3;
        int32_t v = (int32_t)b[0] | ((int32_t)b[1] << 8) | ((int32_t)b[2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        acc += v;
      }
      out[i] = (float)(acc * s);
    }
  } else if (info.bits == 32) {
    const double s = inv_c / 2147483648.0;
    for (int64_t i = 0; i < info.n_frames; i++) {
      double acc = 0;
      for (int c = 0; c < C; c++) {
        acc += (int32_t)rd_u32(p + (i * C + c) * 4);
      }
      out[i] = (float)(acc * s);
    }
  } else {
    return -6;
  }
  return 0;
}

// ---- polyphase FIR resampler (scipy.signal.resample_poly semantics) ----
//
// y[m] = sum_t fir[t] * x_up[m*down - t + offset] where x_up is the
// zero-stuffed upsampled input. Implemented phase-wise so only real
// input samples are touched. `fir` is the full lowpass prototype
// (length `taps`, already scaled by `up`); offset = (taps - 1) / 2
// centers the filter (odd taps expected), matching resample_poly's
// group-delay compensation.

int64_t csm_resample_len(int64_t n, int32_t up, int32_t down) {
  return (n * (int64_t)up + down - 1) / down;
}

int csm_resample(const float* in, int64_t n, int32_t up, int32_t down,
                 const double* fir, int32_t taps, float* out) {
  if (up <= 0 || down <= 0 || taps <= 0) return -1;
  const int64_t n_out = csm_resample_len(n, up, down);
  const int32_t center = (taps - 1) / 2;
  for (int64_t m = 0; m < n_out; m++) {
    // position in the upsampled stream whose filter window we evaluate
    const int64_t pos = m * down + center;
    // x_up[j] is nonzero only at j = k*up (== in[k])
    // accumulate fir[pos - k*up] * in[k] over the filter support
    int64_t k_hi = pos / up;              // largest k with k*up <= pos
    int64_t k_lo = (pos - (taps - 1) + up - 1) / up; // smallest k in support
    if (k_hi > n - 1) k_hi = n - 1;
    if (k_lo < 0) k_lo = 0;
    double acc = 0;
    for (int64_t k = k_lo; k <= k_hi; k++) {
      acc += fir[pos - k * up] * in[k];
    }
    out[m] = (float)acc;
  }
  return 0;
}

// ---- segmentation helper: energy-based silence trim bounds ----
// Returns [start, end) of the region whose RMS over `win`-sample windows
// exceeds `threshold` * global RMS. Used by the loader to drop leading/
// trailing silence before segmentation.
int csm_trim_bounds(const float* in, int64_t n, int32_t win, float threshold,
                    int64_t* start, int64_t* end) {
  if (n <= 0 || win <= 0) return -1;
  double total = 0;
  for (int64_t i = 0; i < n; i++) total += (double)in[i] * in[i];
  const double global_rms = sqrt(total / (double)n);
  const double gate = (double)threshold * global_rms;
  const double gate2 = gate * gate * win;

  int64_t s = 0, e = n;
  for (int64_t i = 0; i + win <= n; i += win) {
    double acc = 0;
    for (int32_t j = 0; j < win; j++) acc += (double)in[i + j] * in[i + j];
    if (acc >= gate2) { s = i; break; }
  }
  for (int64_t i = n - win; i >= 0; i -= win) {
    double acc = 0;
    for (int32_t j = 0; j < win; j++) acc += (double)in[i + j] * in[i + j];
    if (acc >= gate2) { e = i + win; break; }
  }
  if (e < s) { s = 0; e = n; }
  *start = s;
  *end = e;
  return 0;
}

}  // extern "C"
