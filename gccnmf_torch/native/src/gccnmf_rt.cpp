// Native host-runtime library for the realtime GCC-NMF audio path.
//
// The reference's realtime runtime is three OS processes exchanging audio
// blocks through multiprocessing shared memory with an Event handshake
// (reference: gccNMF/realtime/runRealtimeGCCNMF.py:54-93,
// audioProcessor.py:106-132, utils.py:34-70). Here the DSP lives in one
// device step per block, so the runtime problem shrinks to the host side:
// a deadline-critical audio callback must exchange blocks with the Python
// thread that dispatches to the device, without taking the GIL and without
// locks. This library provides that tier in C++:
//
//   - PCM <-> float conversion (int16/int32, clip-protected), the per-block
//     work the reference does in NumPy inside its audio callback
//     (wavfile.py:57-131);
//   - a lock-free single-producer/single-consumer ring buffer of float
//     samples (C++11 atomics, acquire/release), replacing the Event
//     handshake between the audio and DSP processes;
//   - host-side overlap-add state (windowed frame accumulation + fixed-delay
//     block emission) mirroring OverlapAddProcessor (utils.py:72-118) for
//     runtimes that assemble output on the host;
//   - a block-time telemetry recorder (min/max/mean over a window) matching
//     the reference's 2-second processing-time logs (audioProcessor.py:98-102).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All functions are thread-safe under the SPSC contract noted per type.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

#if defined(_MSC_VER)
#define GCCNMF_EXPORT extern "C" __declspec(dllexport)
#else
#define GCCNMF_EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

inline float clip1(float x) {
    if (x > 1.0f) return 1.0f;
    if (x < -1.0f) return -1.0f;
    return x;
}

// float -> int16 with the reference convention (wavfile.py float2pcm, the
// same one utils/wav.float_to_pcm implements): scale by 2^15, clip to the
// int16 range, truncate toward zero. Keeping one convention host-wide makes
// pcm16_to_float(float_to_pcm16(x)) the documented round trip.
inline int16_t f32_to_i16(float x) {
    float v = x * 32768.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    return static_cast<int16_t>(v);
}

// float -> int32, same convention at 2^31.
inline int32_t f32_to_i32(float x) {
    double v = static_cast<double>(x) * 2147483648.0;
    if (v > 2147483647.0) v = 2147483647.0;
    if (v < -2147483648.0) v = -2147483648.0;
    return static_cast<int32_t>(v);
}

}  // namespace

// --------------------------------------------------------------------------
// PCM conversion (reference: gccNMF/wavfile.py pcm2float/float2pcm)
// --------------------------------------------------------------------------

GCCNMF_EXPORT void gccnmf_pcm16_to_float(const int16_t* in, float* out,
                                         int64_t n) {
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]) * scale;
}

GCCNMF_EXPORT void gccnmf_float_to_pcm16(const float* in, int16_t* out,
                                         int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = f32_to_i16(in[i]);
}

GCCNMF_EXPORT void gccnmf_pcm32_to_float(const int32_t* in, float* out,
                                         int64_t n) {
    const double scale = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<float>(static_cast<double>(in[i]) * scale);
}

GCCNMF_EXPORT void gccnmf_float_to_pcm32(const float* in, int32_t* out,
                                         int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = f32_to_i32(in[i]);
}

// Interleaved stereo PCM16 -> planar float (C, n) and back: the layout hop
// every audio callback performs (device frames are interleaved, DSP wants
// channel-major).
GCCNMF_EXPORT void gccnmf_deinterleave_pcm16(const int16_t* in, float* out,
                                             int64_t frames, int32_t channels) {
    const float scale = 1.0f / 32768.0f;
    for (int32_t c = 0; c < channels; ++c) {
        float* dst = out + static_cast<int64_t>(c) * frames;
        const int16_t* src = in + c;
        for (int64_t i = 0; i < frames; ++i)
            dst[i] = static_cast<float>(src[i * channels]) * scale;
    }
}

GCCNMF_EXPORT void gccnmf_interleave_pcm16(const float* in, int16_t* out,
                                           int64_t frames, int32_t channels) {
    for (int32_t c = 0; c < channels; ++c) {
        const float* src = in + static_cast<int64_t>(c) * frames;
        int16_t* dst = out + c;
        for (int64_t i = 0; i < frames; ++i)
            dst[i * channels] = f32_to_i16(src[i]);
    }
}

// --------------------------------------------------------------------------
// Lock-free SPSC ring buffer of float32 samples.
//
// One producer thread (audio callback) and one consumer thread (Python DSP
// dispatch loop), or vice versa. capacity is rounded up to a power of two;
// one slot is sacrificed to distinguish full from empty.
// --------------------------------------------------------------------------

struct GccnmfRing {
    float* data;
    uint64_t mask;  // capacity - 1 (capacity is a power of two)
    std::atomic<uint64_t> head{0};  // next read index  (consumer-owned)
    std::atomic<uint64_t> tail{0};  // next write index (producer-owned)
};

GCCNMF_EXPORT GccnmfRing* gccnmf_ring_create(uint64_t min_capacity) {
    uint64_t cap = 1;
    while (cap < min_capacity + 1) cap <<= 1;
    GccnmfRing* r = new (std::nothrow) GccnmfRing();
    if (!r) return nullptr;
    r->data = new (std::nothrow) float[cap]();
    if (!r->data) {
        delete r;
        return nullptr;
    }
    r->mask = cap - 1;
    return r;
}

GCCNMF_EXPORT void gccnmf_ring_destroy(GccnmfRing* r) {
    if (!r) return;
    delete[] r->data;
    delete r;
}

GCCNMF_EXPORT uint64_t gccnmf_ring_capacity(const GccnmfRing* r) {
    return r->mask;  // usable capacity (one slot reserved)
}

GCCNMF_EXPORT uint64_t gccnmf_ring_readable(const GccnmfRing* r) {
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t head = r->head.load(std::memory_order_acquire);
    return tail - head;
}

GCCNMF_EXPORT uint64_t gccnmf_ring_writable(const GccnmfRing* r) {
    return r->mask - gccnmf_ring_readable(r);
}

// Writes up to n samples; returns samples written (may be < n when full).
// Producer thread only.
GCCNMF_EXPORT uint64_t gccnmf_ring_write(GccnmfRing* r, const float* src,
                                         uint64_t n) {
    uint64_t head = r->head.load(std::memory_order_acquire);
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t space = r->mask - (tail - head);
    if (n > space) n = space;
    for (uint64_t i = 0; i < n; ++i) r->data[(tail + i) & r->mask] = src[i];
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

// Reads up to n samples; returns samples read. Consumer thread only.
GCCNMF_EXPORT uint64_t gccnmf_ring_read(GccnmfRing* r, float* dst, uint64_t n) {
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t avail = tail - head;
    if (n > avail) n = avail;
    for (uint64_t i = 0; i < n; ++i) dst[i] = r->data[(head + i) & r->mask];
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Peek without consuming (consumer thread only) — telemetry reads.
GCCNMF_EXPORT uint64_t gccnmf_ring_peek(const GccnmfRing* r, float* dst,
                                        uint64_t n) {
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t avail = tail - head;
    if (n > avail) n = avail;
    for (uint64_t i = 0; i < n; ++i) dst[i] = r->data[(head + i) & r->mask];
    return n;
}

// --------------------------------------------------------------------------
// Host-side overlap-add engine (reference: utils.py:72-118).
//
// State: an output accumulation ring of num_blocks * block_size samples per
// channel. add_frames() overlap-adds windowed synthesis frames whose starts
// step by hop_size; emit_block() returns the completed block at the fixed
// 2-block delay (outputBuffer[-3B:-2B] in the reference) and slides the ring.
// Single-threaded use (the DSP loop).
// --------------------------------------------------------------------------

struct GccnmfOla {
    float* buf;  // (channels, num_blocks * block_size), channel-major
    int32_t channels;
    int32_t block_size;
    int32_t num_blocks;
};

GCCNMF_EXPORT GccnmfOla* gccnmf_ola_create(int32_t channels, int32_t block_size,
                                           int32_t num_blocks) {
    GccnmfOla* o = new (std::nothrow) GccnmfOla();
    if (!o) return nullptr;
    int64_t n = static_cast<int64_t>(channels) * block_size * num_blocks;
    o->buf = new (std::nothrow) float[n]();
    if (!o->buf) {
        delete o;
        return nullptr;
    }
    o->channels = channels;
    o->block_size = block_size;
    o->num_blocks = num_blocks;
    return o;
}

GCCNMF_EXPORT void gccnmf_ola_destroy(GccnmfOla* o) {
    if (!o) return;
    delete[] o->buf;
    delete o;
}

// Slide the ring left by one block (zero-fill the tail), then overlap-add
// num_frames windowed frames of length frame_size at hop_size spacing, with
// the last frame ending flush at the buffer end (reference utils.py:101-114:
// frames are added at offsets measured back from the end).
// frames: (channels, num_frames, frame_size), channel-major contiguous.
GCCNMF_EXPORT void gccnmf_ola_add_block(GccnmfOla* o, const float* frames,
                                        int32_t num_frames, int32_t frame_size,
                                        int32_t hop_size) {
    const int64_t total = static_cast<int64_t>(o->block_size) * o->num_blocks;
    for (int32_t c = 0; c < o->channels; ++c) {
        float* buf = o->buf + static_cast<int64_t>(c) * total;
        std::memmove(buf, buf + o->block_size,
                     (total - o->block_size) * sizeof(float));
        std::memset(buf + (total - o->block_size), 0,
                    o->block_size * sizeof(float));
        const float* fch =
            frames + static_cast<int64_t>(c) * num_frames * frame_size;
        for (int32_t f = 0; f < num_frames; ++f) {
            int64_t start =
                total - frame_size - static_cast<int64_t>(num_frames - 1 - f) * hop_size;
            if (start < 0) continue;  // frame span exceeds the ring: drop
            const float* src = fch + static_cast<int64_t>(f) * frame_size;
            float* dst = buf + start;
            for (int32_t i = 0; i < frame_size; ++i) dst[i] += src[i];
        }
    }
}

// Copy out the block at 2-block delay from the end: buf[-3B:-2B].
GCCNMF_EXPORT void gccnmf_ola_emit_block(const GccnmfOla* o, float* out) {
    const int64_t total = static_cast<int64_t>(o->block_size) * o->num_blocks;
    const int64_t start = total - 3LL * o->block_size;
    for (int32_t c = 0; c < o->channels; ++c) {
        std::memcpy(out + static_cast<int64_t>(c) * o->block_size,
                    o->buf + static_cast<int64_t>(c) * total + start,
                    o->block_size * sizeof(float));
    }
}

// --------------------------------------------------------------------------
// Block-time telemetry (reference: audioProcessor.py:98-102,130).
// Fixed-capacity ring of per-block durations; min/max/mean over the held
// window. Producer-only writes; stats may be read from any thread (tearing
// tolerated, like the reference's unlocked telemetry reads).
// --------------------------------------------------------------------------

// values are atomic<double> (lock-free 8-byte loads/stores on x86-64 and
// aarch64) so cross-thread stats/snapshot reads are formally race-free:
// relaxed ordering everywhere — a reader may still see a mid-update MIX of
// old and new entries (that tearing-at-the-window level is the accepted
// contract, as in the reference's unlocked telemetry), but each individual
// load is now a well-defined double, not UB.
struct GccnmfTimes {
    std::atomic<double>* values;
    int64_t capacity;
    std::atomic<int64_t> count{0};
};

GCCNMF_EXPORT GccnmfTimes* gccnmf_times_create(int64_t capacity) {
    GccnmfTimes* t = new (std::nothrow) GccnmfTimes();
    if (!t) return nullptr;
    t->values = new (std::nothrow) std::atomic<double>[capacity];
    if (!t->values) {
        delete t;
        return nullptr;
    }
    for (int64_t i = 0; i < capacity; ++i)
        t->values[i].store(0.0, std::memory_order_relaxed);
    t->capacity = capacity;
    return t;
}

GCCNMF_EXPORT void gccnmf_times_destroy(GccnmfTimes* t) {
    if (!t) return;
    delete[] t->values;
    delete t;
}

GCCNMF_EXPORT void gccnmf_times_record(GccnmfTimes* t, double seconds) {
    int64_t c = t->count.load(std::memory_order_relaxed);
    t->values[c % t->capacity].store(seconds, std::memory_order_relaxed);
    t->count.store(c + 1, std::memory_order_release);
}

// Fills out[0..3] = min, max, mean, held-count over the current window.
GCCNMF_EXPORT void gccnmf_times_stats(const GccnmfTimes* t, double* out) {
    int64_t c = t->count.load(std::memory_order_acquire);
    int64_t held = c < t->capacity ? c : t->capacity;
    if (held == 0) {
        out[0] = out[1] = out[2] = 0.0;
        out[3] = 0.0;
        return;
    }
    double first = t->values[0].load(std::memory_order_relaxed);
    double mn = first, mx = first, sum = 0.0;
    for (int64_t i = 0; i < held; ++i) {
        double v = t->values[i].load(std::memory_order_relaxed);
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        sum += v;
    }
    out[0] = mn;
    out[1] = mx;
    out[2] = sum / static_cast<double>(held);
    out[3] = static_cast<double>(held);
}

// Copies the held window (unordered) into out[0..max_n); returns how many
// values were written. Percentile math stays host-side — the window is
// small; window-level mixing of old/new entries is tolerated like
// gccnmf_times_stats, but every load is an atomic (race-free) read.
GCCNMF_EXPORT int64_t gccnmf_times_snapshot(const GccnmfTimes* t, double* out,
                                            int64_t max_n) {
    int64_t c = t->count.load(std::memory_order_acquire);
    int64_t held = c < t->capacity ? c : t->capacity;
    if (held > max_n) held = max_n;
    for (int64_t i = 0; i < held; ++i)
        out[i] = t->values[i].load(std::memory_order_relaxed);
    return held;
}

GCCNMF_EXPORT int32_t gccnmf_rt_abi_version() { return 2; }
