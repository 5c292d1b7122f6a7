// Lock-free single-producer / single-consumer LATEST-WINS frame slot.
//
// The replacement for the reference's depth-1 manager queues
// (reference pbp.py:24-30: drop stale item, put newest): the capture thread
// publishes every decoded frame; the device feeder always consumes the
// newest one; intermediate frames are dropped, bounding latency.  Unlike
// mp.Queue there is no pickling and no server process — one memcpy in, one
// memcpy out, and the producer-side copy runs with the Python GIL released
// (ctypes releases it around foreign calls).
//
// Triple-buffer exchange: the producer fills a back buffer and atomically
// swaps it into the "ready" slot; the consumer atomically takes "ready".
// Neither side ever waits on the other, and frames are never torn.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Slot {
    uint8_t* data;
    double timestamp;
    double sampling_freq;
    int32_t calibrating;
    int64_t seq;
};

struct FrameQueue {
    size_t frame_bytes;
    Slot slots[3];
    // Index of the buffer each role owns; "ready" additionally carries a
    // "fresh" bit (bit 2) so the consumer can tell new data from old.
    std::atomic<int> ready;   // slot index | FRESH_BIT
    int back;                 // producer-owned slot index
    int front;                // consumer-owned slot index
    std::atomic<int64_t> next_seq;
};

constexpr int FRESH_BIT = 4;
constexpr int IDX_MASK = 3;

}  // namespace

extern "C" {

void fq_destroy(FrameQueue* q);

// Shared producer publish tail: stamp metadata on the back buffer and
// atomically swap it into "ready" (the lock-free handshake lives in ONE
// place for both put entry points).
static void fq_publish(FrameQueue* q, double timestamp,
                       double sampling_freq, int32_t calibrating) {
    Slot& s = q->slots[q->back];
    s.timestamp = timestamp;
    s.sampling_freq = sampling_freq;
    s.calibrating = calibrating;
    s.seq = q->next_seq.fetch_add(1, std::memory_order_relaxed);
    int prev = q->ready.exchange(q->back | FRESH_BIT,
                                 std::memory_order_acq_rel);
    q->back = prev & IDX_MASK;
}

FrameQueue* fq_create(size_t frame_bytes) {
    auto* q = new (std::nothrow) FrameQueue();
    if (!q) return nullptr;
    q->frame_bytes = frame_bytes;
    for (int i = 0; i < 3; ++i) q->slots[i].data = nullptr;
    for (int i = 0; i < 3; ++i) {
        q->slots[i].data = new (std::nothrow) uint8_t[frame_bytes];
        if (!q->slots[i].data) {
            // Free the queue and earlier buffers before reporting failure
            // (fq_destroy tolerates null slot pointers).
            fq_destroy(q);
            return nullptr;
        }
        q->slots[i].seq = 0;
    }
    q->ready.store(0, std::memory_order_relaxed);
    q->back = 1;
    q->front = 2;
    q->next_seq.store(1, std::memory_order_relaxed);
    return q;
}

void fq_destroy(FrameQueue* q) {
    if (!q) return;
    for (int i = 0; i < 3; ++i) delete[] q->slots[i].data;
    delete q;
}

// Producer: publish a frame (copies `data`; drops whatever the consumer
// has not picked up yet — the latest-wins policy).
void fq_put(FrameQueue* q, const uint8_t* data, double timestamp,
            double sampling_freq, int32_t calibrating) {
    std::memcpy(q->slots[q->back].data, data, q->frame_bytes);
    fq_publish(q, timestamp, sampling_freq, calibrating);
}

// Consumer: fetch the newest frame into `out`.  Returns its sequence number
// (monotonic from 1), or 0 if nothing new since the last call and
// `require_fresh` is set; with require_fresh=0 re-reads the last frame.
int64_t fq_get(FrameQueue* q, uint8_t* out, double* timestamp,
               double* sampling_freq, int32_t* calibrating,
               int32_t require_fresh) {
    int ready = q->ready.load(std::memory_order_acquire);
    if (ready & FRESH_BIT) {
        int prev = q->ready.exchange(q->front, std::memory_order_acq_rel);
        q->front = prev & IDX_MASK;
    } else if (require_fresh) {
        return 0;
    }
    Slot& s = q->slots[q->front];
    if (s.seq == 0) return 0;  // nothing ever published
    std::memcpy(out, s.data, q->frame_bytes);
    *timestamp = s.timestamp;
    *sampling_freq = s.sampling_freq;
    *calibrating = s.calibrating;
    return s.seq;
}

int64_t fq_latest_seq(FrameQueue* q) {
    return q->next_seq.load(std::memory_order_relaxed) - 1;
}

// Producer: publish an interleaved HWC frame PLANARIZED (slot holds
// [C, H, W]).  The engine's kernels consume planar frames, so the
// HWC->CHW transpose must happen somewhere on the host; doing it inside
// this (GIL-released) producer-side copy runs it in the per-stream
// capture threads in parallel and makes the consumer's batch gather a
// straight contiguous memcpy — previously the feeder paid a numpy
// strided transpose per stream per batch on the single driver thread.
// Per-channel loops: sequential writes, stride-c reads (memory-bound;
// the compiler vectorizes the c=3 case fine).
void fq_put_planar(FrameQueue* q, const uint8_t* hwc, int64_t h,
                   int64_t w, int64_t c, double timestamp,
                   double sampling_freq, int32_t calibrating) {
    Slot& s = q->slots[q->back];
    const int64_t hw = h * w;
    for (int64_t ch = 0; ch < c; ++ch) {
        uint8_t* dst = s.data + ch * hw;
        const uint8_t* src = hwc + ch;
        for (int64_t i = 0; i < hw; ++i) dst[i] = src[i * c];
    }
    fq_publish(q, timestamp, sampling_freq, calibrating);
}

}  // extern "C"
