// Native frame repack kernels — the framework's analogue of the
// reference's SIMD plane copiers (Source/Helper.cpp:414-900,
// Source/Utils/gpu_memcpy_sse4.h).  Compiled with -O3 -march=native so the
// compiler autovectorizes the byte-shuffle loops; exposed to Python via
// ctypes (videorenderer/io/native.py).
//
// The *_p entry points take a src_pitch (bytes per packed/luma row, like
// the reference copiers' src_pitch argument, Source/Helper.cpp:414-428) so
// pitched decoder buffers repack straight to planar with no intermediate
// host copy; negative pitch = bottom-up rows for the DIB RGB formats.
// The pitchless entry points forward with the tight pitch.  Outputs match
// videorenderer/formats.py semantics (10-bit values MSB-aligned into
// uint16 planes, value << 6).

#include <cstdint>
#include <cstring>
#include <cstddef>

using std::ptrdiff_t;

extern "C" {

// NV12: Y plane passthrough + UV deinterleave (pitched).
void vrt_nv12_split_p(const uint8_t* src, int width, int height,
                      int src_pitch, uint8_t* y, uint8_t* u, uint8_t* v) {
    for (int row = 0; row < height; row++)
        std::memcpy(y + (size_t)row * width, src + (size_t)row * src_pitch,
                    width);
    const uint8_t* uvp = src + (size_t)src_pitch * height;
    const int cw = width / 2;
    for (int row = 0; row < height / 2; row++) {
        const uint8_t* uv = uvp + (size_t)row * src_pitch;
        uint8_t* ur = u + (size_t)row * cw;
        uint8_t* vr = v + (size_t)row * cw;
        for (int i = 0; i < cw; i++) {
            ur[i] = uv[2 * i];
            vr[i] = uv[2 * i + 1];
        }
    }
}

void vrt_nv12_split(const uint8_t* src, int width, int height,
                    uint8_t* y, uint8_t* u, uint8_t* v) {
    vrt_nv12_split_p(src, width, height, width, y, u, v);
}

// P010/P016 + P210/P216: 16-bit biplanar split (pitch in BYTES; chroma_div_h
// 2 for 4:2:0, 1 for 4:2:2).
void vrt_p01x_split_p(const uint16_t* src, int width, int height,
                      int src_pitch, int chroma_div_h,
                      uint16_t* y, uint16_t* u, uint16_t* v) {
    const int pitch_w = src_pitch / 2;
    for (int row = 0; row < height; row++)
        std::memcpy(y + (size_t)row * width, src + (size_t)row * pitch_w,
                    (size_t)width * 2);
    const uint16_t* uvp = src + (size_t)pitch_w * height;
    const int cw = width / 2;
    for (int row = 0; row < height / chroma_div_h; row++) {
        const uint16_t* uv = uvp + (size_t)row * pitch_w;
        uint16_t* ur = u + (size_t)row * cw;
        uint16_t* vr = v + (size_t)row * cw;
        for (int i = 0; i < cw; i++) {
            ur[i] = uv[2 * i];
            vr[i] = uv[2 * i + 1];
        }
    }
}

void vrt_p010_split(const uint16_t* src, int width, int height,
                    uint16_t* y, uint16_t* u, uint16_t* v) {
    vrt_p01x_split_p(src, width, height, width * 2, 2, y, u, v);
}

void vrt_p210_split(const uint16_t* src, int width, int height,
                    uint16_t* y, uint16_t* u, uint16_t* v) {
    vrt_p01x_split_p(src, width, height, width * 2, 1, y, u, v);
}

// YUY2 (Y0 U Y1 V) -> planar Y + half-width U,V (pitched).
void vrt_yuy2_to_planar_p(const uint8_t* src, int width, int height,
                          int src_pitch, uint8_t* y, uint8_t* u, uint8_t* v) {
    const int cw = width / 2;
    for (int row = 0; row < height; row++) {
        const uint8_t* s = src + (size_t)row * src_pitch;
        uint8_t* yr = y + (size_t)row * width;
        uint8_t* ur = u + (size_t)row * cw;
        uint8_t* vr = v + (size_t)row * cw;
        for (int i = 0; i < cw; i++) {
            yr[2 * i] = s[4 * i];
            ur[i] = s[4 * i + 1];
            yr[2 * i + 1] = s[4 * i + 2];
            vr[i] = s[4 * i + 3];
        }
    }
}

void vrt_yuy2_to_planar(const uint8_t* src, int width, int height,
                        uint8_t* y, uint8_t* u, uint8_t* v) {
    vrt_yuy2_to_planar_p(src, width, height, width * 2, y, u, v);
}

// UYVY (U Y0 V Y1) -> planar (pitched).
void vrt_uyvy_to_planar_p(const uint8_t* src, int width, int height,
                          int src_pitch, uint8_t* y, uint8_t* u, uint8_t* v) {
    const int cw = width / 2;
    for (int row = 0; row < height; row++) {
        const uint8_t* s = src + (size_t)row * src_pitch;
        uint8_t* yr = y + (size_t)row * width;
        uint8_t* ur = u + (size_t)row * cw;
        uint8_t* vr = v + (size_t)row * cw;
        for (int i = 0; i < cw; i++) {
            ur[i] = s[4 * i];
            yr[2 * i] = s[4 * i + 1];
            vr[i] = s[4 * i + 2];
            yr[2 * i + 1] = s[4 * i + 3];
        }
    }
}

void vrt_uyvy_to_planar(const uint8_t* src, int width, int height,
                        uint8_t* y, uint8_t* u, uint8_t* v) {
    vrt_uyvy_to_planar_p(src, width, height, width * 2, y, u, v);
}

// Y210/Y216 (u16 Y0 U Y1 V) -> planar 16-bit (pitch in bytes).
void vrt_y210_to_planar_p(const uint16_t* src, int width, int height,
                          int src_pitch, uint16_t* y, uint16_t* u,
                          uint16_t* v) {
    const int pitch_w = src_pitch / 2;
    const int cw = width / 2;
    for (int row = 0; row < height; row++) {
        const uint16_t* s = src + (size_t)row * pitch_w;
        uint16_t* yr = y + (size_t)row * width;
        uint16_t* ur = u + (size_t)row * cw;
        uint16_t* vr = v + (size_t)row * cw;
        for (int i = 0; i < cw; i++) {
            yr[2 * i] = s[4 * i];
            ur[i] = s[4 * i + 1];
            yr[2 * i + 1] = s[4 * i + 2];
            vr[i] = s[4 * i + 3];
        }
    }
}

void vrt_y210_to_planar(const uint16_t* src, int width, int height,
                        uint16_t* y, uint16_t* u, uint16_t* v) {
    vrt_y210_to_planar_p(src, width, height, width * 4, y, u, v);
}

// v210: 6 px / 16 bytes, 128-byte aligned rows -> planar 16-bit MSB-aligned
// (CopyFrameV210 analogue, straight to planar instead of Y210).
void vrt_v210_to_planar_p(const uint32_t* src, int width, int height,
                          int src_pitch, uint16_t* y, uint16_t* u,
                          uint16_t* v) {
    const int row_dwords = src_pitch / 4;
    const int groups = row_dwords / 4;
    const int cw = width / 2;
    for (int row = 0; row < height; row++) {
        const uint32_t* s = src + (size_t)row * row_dwords;
        uint16_t* yr = y + (size_t)row * width;
        uint16_t* ur = u + (size_t)row * cw;
        uint16_t* vr = v + (size_t)row * cw;
        for (int g = 0; g < groups; g++) {
            const uint32_t d0 = s[4 * g], d1 = s[4 * g + 1];
            const uint32_t d2 = s[4 * g + 2], d3 = s[4 * g + 3];
            const int px = 6 * g;
            const int cx = 3 * g;
            if (px + 5 < width) {
                yr[px + 0] = (uint16_t)(((d0 >> 10) & 0x3FF) << 6);
                yr[px + 1] = (uint16_t)((d1 & 0x3FF) << 6);
                yr[px + 2] = (uint16_t)(((d1 >> 20) & 0x3FF) << 6);
                yr[px + 3] = (uint16_t)(((d2 >> 10) & 0x3FF) << 6);
                yr[px + 4] = (uint16_t)((d3 & 0x3FF) << 6);
                yr[px + 5] = (uint16_t)(((d3 >> 20) & 0x3FF) << 6);
                ur[cx + 0] = (uint16_t)((d0 & 0x3FF) << 6);
                ur[cx + 1] = (uint16_t)(((d1 >> 10) & 0x3FF) << 6);
                ur[cx + 2] = (uint16_t)(((d2 >> 20) & 0x3FF) << 6);
                vr[cx + 0] = (uint16_t)(((d0 >> 20) & 0x3FF) << 6);
                vr[cx + 1] = (uint16_t)((d2 & 0x3FF) << 6);
                vr[cx + 2] = (uint16_t)(((d3 >> 10) & 0x3FF) << 6);
            } else {
                // tail group: bounds-checked
                uint16_t yv[6] = {
                    (uint16_t)(((d0 >> 10) & 0x3FF) << 6),
                    (uint16_t)((d1 & 0x3FF) << 6),
                    (uint16_t)(((d1 >> 20) & 0x3FF) << 6),
                    (uint16_t)(((d2 >> 10) & 0x3FF) << 6),
                    (uint16_t)((d3 & 0x3FF) << 6),
                    (uint16_t)(((d3 >> 20) & 0x3FF) << 6)};
                uint16_t uvv[3] = {
                    (uint16_t)((d0 & 0x3FF) << 6),
                    (uint16_t)(((d1 >> 10) & 0x3FF) << 6),
                    (uint16_t)(((d2 >> 20) & 0x3FF) << 6)};
                uint16_t vvv[3] = {
                    (uint16_t)(((d0 >> 20) & 0x3FF) << 6),
                    (uint16_t)((d2 & 0x3FF) << 6),
                    (uint16_t)(((d3 >> 10) & 0x3FF) << 6)};
                for (int k = 0; k < 6 && px + k < width; k++) yr[px + k] = yv[k];
                for (int k = 0; k < 3 && cx + k < cw; k++) { ur[cx + k] = uvv[k]; vr[cx + k] = vvv[k]; }
            }
        }
    }
}

void vrt_v210_to_planar(const uint32_t* src, int width, int height,
                        uint16_t* y, uint16_t* u, uint16_t* v) {
    vrt_v210_to_planar_p(src, width, height, ((width + 47) / 48) * 128,
                         y, u, v);
}

// 10-bit LSB -> 16-bit MSB-aligned (CopyPlane10to16 analogue, value << 6).
void vrt_shift10to16(const uint16_t* src, uint16_t* dst, size_t n) {
    for (size_t i = 0; i < n; i++) dst[i] = (uint16_t)(src[i] << 6);
}

// RGB24 (BGR bytes) -> separate R,G,B planes (CopyFrameRGB24 analogue;
// negative pitch = bottom-up DIB rows, the reference starts at
// srcData + srcPitch * (1 - lines), Source/DX11VideoProcessor.cpp:1245-1248).
void vrt_rgb24_to_planar_p(const uint8_t* src, int width, int height,
                           int src_pitch, uint8_t* r, uint8_t* g,
                           uint8_t* b) {
    for (int row = 0; row < height; row++) {
        const int srow = src_pitch < 0 ? height - 1 - row : row;
        const uint8_t* s = src + (ptrdiff_t)srow *
            (src_pitch < 0 ? -src_pitch : src_pitch);
        uint8_t* rr = r + (size_t)row * width;
        uint8_t* gr = g + (size_t)row * width;
        uint8_t* br = b + (size_t)row * width;
        for (int i = 0; i < width; i++) {
            br[i] = s[3 * i];
            gr[i] = s[3 * i + 1];
            rr[i] = s[3 * i + 2];
        }
    }
}

void vrt_rgb24_to_planar(const uint8_t* src, int width, int height,
                         uint8_t* r, uint8_t* g, uint8_t* b) {
    vrt_rgb24_to_planar_p(src, width, height, width * 3, r, g, b);
}

// BGRA32 -> planes (pitched; negative pitch = bottom-up).
void vrt_bgra32_to_planar_p(const uint8_t* src, int width, int height,
                            int src_pitch, uint8_t* r, uint8_t* g,
                            uint8_t* b) {
    for (int row = 0; row < height; row++) {
        const int srow = src_pitch < 0 ? height - 1 - row : row;
        const uint8_t* s = src + (ptrdiff_t)srow *
            (src_pitch < 0 ? -src_pitch : src_pitch);
        uint8_t* rr = r + (size_t)row * width;
        uint8_t* gr = g + (size_t)row * width;
        uint8_t* br = b + (size_t)row * width;
        for (int i = 0; i < width; i++) {
            br[i] = s[4 * i];
            gr[i] = s[4 * i + 1];
            rr[i] = s[4 * i + 2];
        }
    }
}

void vrt_bgra32_to_planar(const uint8_t* src, int width, int height,
                          uint8_t* r, uint8_t* g, uint8_t* b) {
    vrt_bgra32_to_planar_p(src, width, height, width * 4, r, g, b);
}

// r210 (big-endian 2|R10|G10|B10) -> 16-bit planes (CopyFrameR210 analogue).
void vrt_r210_to_planar_p(const uint32_t* src, int width, int height,
                          int src_pitch, uint16_t* r, uint16_t* g,
                          uint16_t* b) {
    const int pitch_d = src_pitch / 4;
    for (int row = 0; row < height; row++) {
        const uint32_t* s = src + (size_t)row * pitch_d;
        uint16_t* rr = r + (size_t)row * width;
        uint16_t* gr = g + (size_t)row * width;
        uint16_t* br = b + (size_t)row * width;
        for (int i = 0; i < width; i++) {
            const uint32_t x = __builtin_bswap32(s[i]);
            rr[i] = (uint16_t)(((x >> 20) & 0x3FF) << 6);
            gr[i] = (uint16_t)(((x >> 10) & 0x3FF) << 6);
            br[i] = (uint16_t)((x & 0x3FF) << 6);
        }
    }
}

void vrt_r210_to_planar(const uint32_t* src, int width, int height,
                        uint16_t* r, uint16_t* g, uint16_t* b) {
    vrt_r210_to_planar_p(src, width, height, width * 4, r, g, b);
}

// float32 [0,1] interleave-pack to RGB8 (presentation path).
void vrt_pack_rgb8(const float* r, const float* g, const float* b,
                   uint8_t* dst, size_t n) {
    for (size_t i = 0; i < n; i++) {
        float rv = r[i] * 255.0f + 0.5f;
        float gv = g[i] * 255.0f + 0.5f;
        float bv = b[i] * 255.0f + 0.5f;
        dst[3 * i] = (uint8_t)(rv < 0 ? 0 : (rv > 255 ? 255 : rv));
        dst[3 * i + 1] = (uint8_t)(gv < 0 ? 0 : (gv > 255 ? 255 : gv));
        dst[3 * i + 2] = (uint8_t)(bv < 0 ? 0 : (bv > 255 ? 255 : bv));
    }
}

// float32 [0,1] -> R10G10B10A2 dwords.
void vrt_pack_rgb10(const float* r, const float* g, const float* b,
                    uint32_t* dst, size_t n) {
    for (size_t i = 0; i < n; i++) {
        float rv = r[i] * 1023.0f + 0.5f;
        float gv = g[i] * 1023.0f + 0.5f;
        float bv = b[i] * 1023.0f + 0.5f;
        uint32_t ri = (uint32_t)(rv < 0 ? 0 : (rv > 1023 ? 1023 : rv));
        uint32_t gi = (uint32_t)(gv < 0 ? 0 : (gv > 1023 ? 1023 : gv));
        uint32_t bi = (uint32_t)(bv < 0 ? 0 : (bv > 1023 ? 1023 : bv));
        dst[i] = ri | (gi << 10) | (bi << 20) | 0xC0000000u;
    }
}

}  // extern "C"
