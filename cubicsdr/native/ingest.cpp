// Native ingest runtime: format conversion + bounded sample ring.
//
// The reference's device layer runs a dedicated thread converting CF32
// stream reads into batches pushed through bounded blocking queues
// (ref: src/sdr/SoapySDRThread.cpp:195-433 readStream/readLoop,
// src/util/ThreadBlockingQueue.h). This is its accelerator-host equivalent:
// tight SIMD-friendly conversion loops from wire formats into the PLANAR float32
// layout the device consumes, plus a mutex-guarded ring buffer providing
// the same bounded back-pressure semantics (try_push shedding when full,
// ref: SoapySDRThread.cpp:384-399).
//
// Built as a shared library, bound via ctypes (cubicsdr/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

extern "C" {

// ---- wire-format conversions into planar float32 ----

void cs_deinterleave_cf32(const float* in, int64_t n, float* re, float* im) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

void cs_convert_cs16(const int16_t* in, int64_t n, float* re, float* im) {
    const float k = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i] * k;
        im[i] = in[2 * i + 1] * k;
    }
}

void cs_convert_cs8(const int8_t* in, int64_t n, float* re, float* im) {
    const float k = 1.0f / 128.0f;
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i] * k;
        im[i] = in[2 * i + 1] * k;
    }
}

void cs_convert_cu8(const uint8_t* in, int64_t n, float* re, float* im) {
    const float k = 1.0f / 127.5f;
    for (int64_t i = 0; i < n; ++i) {
        re[i] = (in[2 * i] - 127.5f) * k;
        im[i] = (in[2 * i + 1] - 127.5f) * k;
    }
}

// Audio float32 [-1,1] -> int16 PCM (WAV writer hot loop,
// ref: src/audio/AudioFileWAV.cpp write path).
void cs_float_to_pcm16(const float* in, int64_t n, int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        out[i] = (int16_t)(v * 32767.0f);
    }
}

// ---- bounded planar sample ring (ThreadBlockingQueue + ReBuffer role) ----
//
// Element-size generic: the ring stores samples in their WIRE format
// (f32, cs16, cs8 planes) so native-format ingest ships fewer bytes to
// the device and converts on the accelerator's vector units instead of
// the host (the reference converts everything to CF32 host-side,
// ref: SoapySDRThread.cpp:253-343 — on an accelerator host that spends
// host-to-device bandwidth on 4-byte samples the wire carried in 1 or 2).

struct Ring {
    std::vector<uint8_t> re, im;
    int64_t cap = 0;    // in samples
    int64_t head = 0;   // read position (samples)
    int64_t size = 0;   // valid samples
    int64_t dropped = 0;
    int32_t elem = 4;   // bytes per sample per plane
    std::mutex mu;
};

void* cs_ring_create2(int64_t capacity, int32_t elem_size) {
    Ring* r = new Ring();
    r->cap = capacity;
    r->elem = elem_size;
    r->re.resize(capacity * elem_size);
    r->im.resize(capacity * elem_size);
    return r;
}

void* cs_ring_create(int64_t capacity) {
    return cs_ring_create2(capacity, 4);
}

void cs_ring_destroy(void* h) { delete (Ring*)h; }

// try_push semantics: if there is not enough room, the whole batch is
// dropped and counted (back-pressure shedding; the reference drops the
// batch when its queue is full rather than blocking the device thread).
int32_t cs_ring_write(void* h, const void* re, const void* im,
                      int64_t n) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    if (r->size + n > r->cap) {
        r->dropped += n;
        return 0;
    }
    const int64_t e = r->elem;
    int64_t w = (r->head + r->size) % r->cap;
    int64_t first = std::min(n, r->cap - w);
    std::memcpy(&r->re[w * e], re, first * e);
    std::memcpy(&r->im[w * e], im, first * e);
    if (n > first) {
        std::memcpy(&r->re[0], (const uint8_t*)re + first * e,
                    (n - first) * e);
        std::memcpy(&r->im[0], (const uint8_t*)im + first * e,
                    (n - first) * e);
    }
    r->size += n;
    return 1;
}

// Blocking-read analog: returns n samples only when available (else 0) —
// the consumer polls at block cadence like the compiled pipeline does.
int32_t cs_ring_read(void* h, void* re, void* im, int64_t n) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    if (r->size < n) return 0;
    const int64_t e = r->elem;
    int64_t first = std::min(n, r->cap - r->head);
    std::memcpy(re, &r->re[r->head * e], first * e);
    std::memcpy(im, &r->im[r->head * e], first * e);
    if (n > first) {
        std::memcpy((uint8_t*)re + first * e, &r->re[0], (n - first) * e);
        std::memcpy((uint8_t*)im + first * e, &r->im[0], (n - first) * e);
    }
    r->head = (r->head + n) % r->cap;
    r->size -= n;
    return 1;
}

int64_t cs_ring_fill(void* h) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    return r->size;
}

int64_t cs_ring_dropped(void* h) {
    Ring* r = (Ring*)h;
    std::lock_guard<std::mutex> lock(r->mu);
    return r->dropped;
}

}  // extern "C"
