// Adaptive binary arithmetic (range) coder + TThresh-style bitplane
// codec for the compression tower (the port's own copy of the JAX
// package's coder, kept byte for byte in its output).
//
// The reference vendors TThresh's arithmetic coder + RLE
// (compression/src/compression.cpp:1-821 wraps the tthresh codec); this
// is an implementation of the same *idea* built on the standard
// LZMA-style binary range coder (public textbook construction: 32-bit
// range, 64-bit low with carry cache, 15-bit adaptive probabilities) with
// significance/refinement/sign contexts per bitplane -- the zero runs the
// paper handles with RLE are absorbed by the per-plane significance
// contexts (a run of zeros costs a fraction of a bit per symbol once the
// model adapts).
//
// Built with g++ into build/fvsrn_tpu_torch/ and exposed as a C ABI for
// ctypes (fvsrn_tpu_torch/arith.py); no third-party code.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 1u << 24;
// 15-bit probabilities: the adaptive floor is p = 1 - 31/32768, i.e.
// ~0.0014 bits per settled symbol -- at 12 bits the floor (1 - 31/4096,
// ~0.011 bits/symbol) dominated the payload of near-empty bitplanes
// (measured round 5: a 64^3 core's zero planes cost 3.3 KB of coder
// noise that LZ4 then re-compressed 2x; 15-bit probs emit ~0.4 KB).
constexpr int kProbBits = 15;
constexpr uint16_t kProbOne = 1u << kProbBits;
constexpr int kAdaptShift = 5;

struct Encoder {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t pending = 0;
  bool first = true;
  std::vector<uint8_t>* out;

  void shift_low() {
    if ((uint32_t)low < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = (uint8_t)(low >> 32);
      if (!first) out->push_back(cache + carry);
      first = false;
      for (; pending > 0; --pending) out->push_back((uint8_t)(0xFF + carry));
      cache = (uint8_t)((uint32_t)low >> 24);
    } else {
      ++pending;
    }
    low = ((uint32_t)low) << 8;
  }

  void encode(int bit, uint16_t& prob) {
    uint32_t bound = (range >> kProbBits) * prob;
    if (!bit) {
      range = bound;
      prob += (kProbOne - prob) >> kAdaptShift;
    } else {
      low += bound;
      range -= bound;
      prob -= prob >> kAdaptShift;
    }
    while (range < kTop) {
      shift_low();
      range <<= 8;
    }
  }

  void finish() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct Decoder {
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;
  const uint8_t* in;
  const uint8_t* end;

  uint8_t next() { return in < end ? *in++ : 0; }

  void init() {
    for (int i = 0; i < 4; ++i) code = (code << 8) | next();
  }

  int decode(uint16_t& prob) {
    uint32_t bound = (range >> kProbBits) * prob;
    int bit;
    if (code < bound) {
      bit = 0;
      range = bound;
      prob += (kProbOne - prob) >> kAdaptShift;
    } else {
      bit = 1;
      code -= bound;
      range -= bound;
      prob -= prob >> kAdaptShift;
    }
    while (range < kTop) {
      code = (code << 8) | next();
      range <<= 8;
    }
    return bit;
  }
};

struct PlaneModel {
  // significance context per plane (zero runs adapt here), refinement,
  // sign -- the context split of embedded bitplane coders
  uint16_t sig[64];
  uint16_t ref;
  uint16_t sign;
  PlaneModel() {
    for (auto& p : sig) p = kProbOne / 2;
    ref = kProbOne / 2;
    sign = kProbOne / 2;
  }
};

}  // namespace

extern "C" {

// Encode n magnitudes (uint64, already bitplane-cut/shifted) + signs
// over `nbits` planes MSB-first. Returns payload bytes, or -1 if the
// output capacity is insufficient.
int fv_ac_encode_planes(const uint64_t* mag, const uint8_t* sign, int n,
                        int nbits, uint8_t* out_buf, int out_cap) {
  std::vector<uint8_t> out;
  out.reserve((size_t)n / 4 + 64);
  Encoder enc;
  enc.out = &out;
  PlaneModel m;
  std::vector<uint8_t> significant((size_t)n, 0);
  for (int p = nbits - 1; p >= 0; --p) {
    uint16_t& sig_ctx = m.sig[p < 64 ? p : 63];
    for (int i = 0; i < n; ++i) {
      int bit = (int)((mag[i] >> p) & 1u);
      if (!significant[i]) {
        enc.encode(bit, sig_ctx);
        if (bit) {
          significant[i] = 1;
          enc.encode(sign[i] ? 1 : 0, m.sign);
        }
      } else {
        enc.encode(bit, m.ref);
      }
    }
  }
  enc.finish();
  if ((int)out.size() > out_cap) return -1;
  std::memcpy(out_buf, out.data(), out.size());
  return (int)out.size();
}

int fv_ac_decode_planes(const uint8_t* in_buf, int in_len, uint64_t* mag,
                        uint8_t* sign, int n, int nbits) {
  Decoder dec;
  dec.in = in_buf;
  dec.end = in_buf + in_len;
  dec.init();
  PlaneModel m;
  std::vector<uint8_t> significant((size_t)n, 0);
  std::memset(mag, 0, sizeof(uint64_t) * (size_t)n);
  std::memset(sign, 0, (size_t)n);
  for (int p = nbits - 1; p >= 0; --p) {
    uint16_t& sig_ctx = m.sig[p < 64 ? p : 63];
    for (int i = 0; i < n; ++i) {
      int bit;
      if (!significant[i]) {
        bit = dec.decode(sig_ctx);
        if (bit) {
          significant[i] = 1;
          sign[i] = (uint8_t)dec.decode(m.sign);
        }
      } else {
        bit = dec.decode(m.ref);
      }
      if (bit) mag[i] |= (uint64_t)1 << p;
    }
  }
  return 0;
}

}  // extern "C"

// 3D-aware bitplane codec: significance contexts keyed on how many of
// the six face neighbors are already significant (the EBCOT/JPEG2000
// context idea adapted to 3D volumes -- cudaCompress's coder likewise
// conditions on local state). Used per Mallat subband (and for the
// TThresh core, whose low-index energy concentration gives the same
// neighbor correlation). Causal state: a neighbor counts if it became
// significant in an earlier plane OR earlier in the current scan --
// the decoder reproduces the identical state.
namespace {

struct Model3D {
  // [min(#significant neighbors, 3)][min(plane index from MSB, 7)]
  uint16_t sig[4][8];
  uint16_t ref[2];  // [0]: first refinement after significance, [1]: later
  uint16_t sign;
  Model3D() {
    for (auto& row : sig)
      for (auto& p : row) p = kProbOne / 2;
    ref[0] = ref[1] = kProbOne / 2;
    sign = kProbOne / 2;
  }
};

inline int neigh_sig(const uint8_t* significant, int i0, int i1, int i2,
                     int n0, int n1, int n2, int s0, int s1) {
  int c = 0;
  if (i0 > 0) c += significant[(i0 - 1) * s0 + i1 * s1 + i2];
  if (i0 + 1 < n0) c += significant[(i0 + 1) * s0 + i1 * s1 + i2];
  if (i1 > 0) c += significant[i0 * s0 + (i1 - 1) * s1 + i2];
  if (i1 + 1 < n1) c += significant[i0 * s0 + (i1 + 1) * s1 + i2];
  if (i2 > 0) c += significant[i0 * s0 + i1 * s1 + i2 - 1];
  if (i2 + 1 < n2) c += significant[i0 * s0 + i1 * s1 + i2 + 1];
  return c < 3 ? c : 3;
}

}  // namespace

extern "C" {

int fv_ac_encode_planes3d(const uint64_t* mag, const uint8_t* sign,
                          int n0, int n1, int n2, int nbits,
                          uint8_t* out_buf, int out_cap) {
  const int n = n0 * n1 * n2;
  const int s0 = n1 * n2, s1 = n2;
  std::vector<uint8_t> out;
  out.reserve((size_t)n / 4 + 64);
  Encoder enc;
  enc.out = &out;
  Model3D m;
  std::vector<uint8_t> significant((size_t)n, 0);
  std::vector<uint8_t> sig_age((size_t)n, 0);
  for (int p = nbits - 1; p >= 0; --p) {
    const int pt = nbits - 1 - p;
    const int ptc = pt < 8 ? pt : 7;
    int i = 0;
    for (int i0 = 0; i0 < n0; ++i0)
      for (int i1 = 0; i1 < n1; ++i1)
        for (int i2 = 0; i2 < n2; ++i2, ++i) {
          int bit = (int)((mag[i] >> p) & 1u);
          if (!significant[i]) {
            int ctx = neigh_sig(significant.data(), i0, i1, i2, n0, n1,
                                n2, s0, s1);
            enc.encode(bit, m.sig[ctx][ptc]);
            if (bit) {
              significant[i] = 1;
              sig_age[i] = (uint8_t)(pt < 255 ? pt : 255);
              enc.encode(sign[i] ? 1 : 0, m.sign);
            }
          } else {
            enc.encode(bit, m.ref[(pt - sig_age[i]) == 1 ? 0 : 1]);
          }
        }
  }
  enc.finish();
  if ((int)out.size() > out_cap) return -1;
  std::memcpy(out_buf, out.data(), out.size());
  return (int)out.size();
}

int fv_ac_decode_planes3d(const uint8_t* in_buf, int in_len,
                          uint64_t* mag, uint8_t* sign, int n0, int n1,
                          int n2, int nbits) {
  const int n = n0 * n1 * n2;
  const int s0 = n1 * n2, s1 = n2;
  Decoder dec;
  dec.in = in_buf;
  dec.end = in_buf + in_len;
  dec.init();
  Model3D m;
  std::vector<uint8_t> significant((size_t)n, 0);
  std::vector<uint8_t> sig_age((size_t)n, 0);
  std::memset(mag, 0, sizeof(uint64_t) * (size_t)n);
  std::memset(sign, 0, (size_t)n);
  for (int p = nbits - 1; p >= 0; --p) {
    const int pt = nbits - 1 - p;
    const int ptc = pt < 8 ? pt : 7;
    int i = 0;
    for (int i0 = 0; i0 < n0; ++i0)
      for (int i1 = 0; i1 < n1; ++i1)
        for (int i2 = 0; i2 < n2; ++i2, ++i) {
          int bit;
          if (!significant[i]) {
            int ctx = neigh_sig(significant.data(), i0, i1, i2, n0, n1,
                                n2, s0, s1);
            bit = dec.decode(m.sig[ctx][ptc]);
            if (bit) {
              significant[i] = 1;
              sig_age[i] = (uint8_t)(pt < 255 ? pt : 255);
              sign[i] = (uint8_t)dec.decode(m.sign);
            }
          } else {
            bit = dec.decode(m.ref[(pt - sig_age[i]) == 1 ? 0 : 1]);
          }
          if (bit) mag[i] |= (uint64_t)1 << p;
        }
  }
  return 0;
}

}  // extern "C"
