// Host-side frame transport: lock-free SPSC frame ring + pacing clock +
// TCP coordinate receiver, exported through a C ABI for ctypes.
//
// Counterparts in the reference (all C/C++ there too):
//  - FrameRing   <- the bounded frame queues in CamCap (src/CamCap.cpp:
//                   141-256), CamCapInterpipe (src/CamCapInterpipe.cpp:
//                   124-312) and vsg.cpp:184-228 — mutex+condvar deques of
//                   cv::Mat there; here a single-producer single-consumer
//                   ring over one preallocated slab (zero allocation and
//                   zero locks in steady state, drop-oldest on overflow like
//                   the reference's queue-full pops).
//  - PacingClock <- the adaptive frame pacing in main-ffmpeg.cpp:697-706.
//  - TcpReceiver <- src/TcpReciever.cpp [sic]: newline-delimited "x y"
//                   pairs, latest pair readable via atomic exchange.
//
// Build: make -C video_stab_tpu/native   (g++ -O3 -shared -fPIC)

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

// ---------------------------------------------------------------------------
// SPSC frame ring
// ---------------------------------------------------------------------------

namespace {

struct FrameRing {
    uint8_t* slab = nullptr;         // capacity * frame_bytes
    int64_t* stamps = nullptr;       // per-slot sequence numbers
    size_t frame_bytes = 0;
    size_t capacity = 0;
    // head: next slot to write (producer); tail: next to read (consumer).
    std::atomic<uint64_t> head{0};
    std::atomic<uint64_t> tail{0};
    std::atomic<uint64_t> pushed{0};
    std::atomic<uint64_t> dropped{0};
};

struct PacingClock {
    std::chrono::steady_clock::time_point next;
    double interval_s = 1.0 / 30.0;
    uint64_t ticks = 0;
    uint64_t late = 0;
};

struct TcpReceiver {
    int listen_fd = -1;
    int port = 0;
    std::thread thread;
    std::atomic<bool> stop{false};
    std::atomic<uint64_t> latest{UINT64_MAX};  // packed (x<<32)|y, MAX=empty
};

}  // namespace

extern "C" {

void* vstab_ring_create(size_t frame_bytes, size_t capacity) {
    auto* r = new FrameRing();
    r->frame_bytes = frame_bytes;
    r->capacity = capacity;
    r->slab = new uint8_t[frame_bytes * capacity];
    r->stamps = new int64_t[capacity];
    return r;
}

void vstab_ring_destroy(void* h) {
    auto* r = static_cast<FrameRing*>(h);
    delete[] r->slab;
    delete[] r->stamps;
    delete r;
}

// Producer: copy a frame in. Drop-oldest when full (advance tail) — the
// reference queues also drop under backpressure (CamCap.cpp:225-242).
// Returns 1 on plain push, 2 if an old frame was dropped to make room.
int vstab_ring_push(void* h, const uint8_t* data, int64_t stamp) {
    auto* r = static_cast<FrameRing*>(h);
    uint64_t head = r->head.load(std::memory_order_relaxed);
    uint64_t tail = r->tail.load(std::memory_order_acquire);
    int result = 1;
    if (head - tail >= r->capacity) {
        // Full: drop oldest. SPSC caveat: the consumer may concurrently
        // advance tail; compare_exchange keeps exactly one of us winning.
        uint64_t expected = tail;
        if (r->tail.compare_exchange_strong(expected, tail + 1,
                                            std::memory_order_acq_rel)) {
            r->dropped.fetch_add(1, std::memory_order_relaxed);
        }
        result = 2;
    }
    size_t slot = static_cast<size_t>(head % r->capacity);
    std::memcpy(r->slab + slot * r->frame_bytes, data, r->frame_bytes);
    r->stamps[slot] = stamp;
    r->head.store(head + 1, std::memory_order_release);
    r->pushed.fetch_add(1, std::memory_order_relaxed);
    return result;
}

// Consumer: copy the oldest frame out. Returns 1 and fills data/stamp, or 0
// if empty. timeout_ms < 0 means no wait.
int vstab_ring_pop(void* h, uint8_t* data, int64_t* stamp, int timeout_ms) {
    auto* r = static_cast<FrameRing*>(h);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms > 0 ? timeout_ms : 0);
    for (;;) {
        uint64_t tail = r->tail.load(std::memory_order_relaxed);
        uint64_t head = r->head.load(std::memory_order_acquire);
        if (head != tail) {
            size_t slot = static_cast<size_t>(tail % r->capacity);
            std::memcpy(data, r->slab + slot * r->frame_bytes,
                        r->frame_bytes);
            if (stamp) *stamp = r->stamps[slot];
            // If the producer dropped this slot from under us the CAS
            // fails; retry with the new tail.
            uint64_t expected = tail;
            if (r->tail.compare_exchange_strong(expected, tail + 1,
                                                std::memory_order_acq_rel)) {
                return 1;
            }
            continue;
        }
        if (timeout_ms < 0 ||
            std::chrono::steady_clock::now() >= deadline) {
            return 0;
        }
        std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
}

size_t vstab_ring_size(void* h) {
    auto* r = static_cast<FrameRing*>(h);
    return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                               r->tail.load(std::memory_order_acquire));
}

uint64_t vstab_ring_pushed(void* h) {
    return static_cast<FrameRing*>(h)->pushed.load();
}

uint64_t vstab_ring_dropped(void* h) {
    return static_cast<FrameRing*>(h)->dropped.load();
}

// ---------------------------------------------------------------------------
// Pacing clock
// ---------------------------------------------------------------------------

void* vstab_pace_create(double fps) {
    auto* p = new PacingClock();
    p->interval_s = fps > 0 ? 1.0 / fps : 0.0;
    p->next = std::chrono::steady_clock::now();
    return p;
}

void vstab_pace_destroy(void* h) { delete static_cast<PacingClock*>(h); }

// Sleep until the next frame deadline; returns lateness in microseconds
// (negative = on time).
int64_t vstab_pace_wait(void* h) {
    auto* p = static_cast<PacingClock*>(h);
    auto now = std::chrono::steady_clock::now();
    auto late_us = std::chrono::duration_cast<std::chrono::microseconds>(
                       now - p->next).count();
    if (late_us < 0) {
        std::this_thread::sleep_until(p->next);
    } else if (late_us > 0) {
        p->late++;
        // Behind schedule: resync to now (the reference's adaptive pacing
        // main-ffmpeg.cpp:697-706 does the same rather than bursting).
        p->next = now;
    }
    p->next += std::chrono::duration_cast<
        std::chrono::steady_clock::duration>(
        std::chrono::duration<double>(p->interval_s));
    p->ticks++;
    return late_us;
}

// ---------------------------------------------------------------------------
// TCP coordinate receiver (TcpReciever.cpp:74-105 semantics)
// ---------------------------------------------------------------------------

static void tcp_loop(TcpReceiver* t) {
    while (!t->stop.load()) {
        sockaddr_in peer{};
        socklen_t len = sizeof(peer);
        int conn = accept(t->listen_fd, reinterpret_cast<sockaddr*>(&peer),
                          &len);
        if (conn < 0) {
            if (t->stop.load()) break;
            std::this_thread::sleep_for(std::chrono::milliseconds(50));
            continue;
        }
        timeval tv{0, 200000};
        setsockopt(conn, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
        char buf[256];
        std::string acc;
        while (!t->stop.load()) {
            ssize_t n = recv(conn, buf, sizeof(buf), 0);
            if (n == 0) break;
            if (n < 0) continue;
            acc.append(buf, static_cast<size_t>(n));
            size_t pos;
            while ((pos = acc.find('\n')) != std::string::npos) {
                std::string line = acc.substr(0, pos);
                acc.erase(0, pos + 1);
                int x, y;
                if (sscanf(line.c_str(), "%d %d", &x, &y) == 2) {
                    uint64_t packed =
                        (static_cast<uint64_t>(static_cast<uint32_t>(x))
                         << 32) |
                        static_cast<uint32_t>(y);
                    t->latest.store(packed, std::memory_order_release);
                }
            }
        }
        close(conn);
    }
}

void* vstab_tcp_create(int port) {
    auto* t = new TcpReceiver();
    t->port = port;
    t->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(t->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = INADDR_ANY;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(t->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
        listen(t->listen_fd, 1) != 0) {
        close(t->listen_fd);
        delete t;
        return nullptr;
    }
    timeval tv{0, 200000};
    setsockopt(t->listen_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    t->thread = std::thread(tcp_loop, t);
    return t;
}

// Atomic exchange: 1 + (x, y) once per update, else 0 (TcpReciever.cpp:63-71).
int vstab_tcp_try_get_latest(void* h, int* x, int* y) {
    auto* t = static_cast<TcpReceiver*>(h);
    uint64_t packed = t->latest.exchange(UINT64_MAX,
                                         std::memory_order_acq_rel);
    if (packed == UINT64_MAX) return 0;
    *x = static_cast<int32_t>(packed >> 32);
    *y = static_cast<int32_t>(packed & 0xffffffffu);
    return 1;
}

void vstab_tcp_destroy(void* h) {
    auto* t = static_cast<TcpReceiver*>(h);
    t->stop.store(true);
    shutdown(t->listen_fd, SHUT_RDWR);
    close(t->listen_fd);
    if (t->thread.joinable()) t->thread.join();
    delete t;
}

}  // extern "C"
