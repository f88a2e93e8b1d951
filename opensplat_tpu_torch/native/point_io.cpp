// Native point-cloud parsing: single-pass COLMAP points3D.bin decode.
//
// Counterpart of the reference's C++ point_io (point_io.cpp:361-394 for
// points3D.bin; the JAX package's native/point_io.cpp): the hot part
// in our Python data layer is the sequential offset scan over
// variable-length track records — O(N) struct.unpack calls. Here the whole
// decode is one pass at memory speed. Exposed via a C ABI consumed with
// ctypes (no pybind11 dependency).
//
// Built at first use by native/loader.py (g++ -O3 -shared -fPIC) into
// opensplat_tpu_torch/_build/native-<hash>/.

#include <cstdint>
#include <cstring>

namespace {

template <typename T>
inline T read_le(const uint8_t *p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;  // assumes little-endian host (x86_64 / aarch64)
}

}  // namespace

extern "C" {

// Number of points declared in a points3D.bin buffer (-1 if too short).
int64_t colmap_points3d_count(const uint8_t *buf, int64_t len) {
    if (len < 8) return -1;
    return static_cast<int64_t>(read_le<uint64_t>(buf));
}

// Single-pass decode of points3D.bin. xyz: (max_points, 3) float32,
// rgb: (max_points, 3) uint8. Returns number of points written, or -1 on
// a malformed/truncated buffer.
int64_t colmap_points3d_parse(const uint8_t *buf, int64_t len, float *xyz,
                              uint8_t *rgb, int64_t max_points) {
    if (len < 8) return -1;
    const uint64_t n = read_le<uint64_t>(buf);
    const uint8_t *p = buf + 8;
    const uint8_t *end = buf + len;
    // record head: u64 id + 3x f64 xyz + 3x u8 rgb + f64 error = 43 bytes
    const int64_t head = 8 + 24 + 3 + 8;
    int64_t count = 0;
    for (uint64_t i = 0; i < n && count < max_points; ++i) {
        if (p + head + 8 > end) return -1;
        xyz[count * 3 + 0] = static_cast<float>(read_le<double>(p + 8));
        xyz[count * 3 + 1] = static_cast<float>(read_le<double>(p + 16));
        xyz[count * 3 + 2] = static_cast<float>(read_le<double>(p + 24));
        rgb[count * 3 + 0] = p[32];
        rgb[count * 3 + 1] = p[33];
        rgb[count * 3 + 2] = p[34];
        const uint64_t track_len = read_le<uint64_t>(p + head);
        p += head + 8 + 8 * track_len;  // track: 2x u32 per element
        ++count;
    }
    if (p > end) return -1;
    return count;
}

}  // extern "C"
