// Host IO native library for the packet modem.
//
// C++ equivalents of the reference's OS-boundary blocks (kept native for the
// same reasons the reference implements them in C++):
//  - TUN device open/read/write, optionally inside a named network namespace
//    (reference: blocks/include/gnuradio-4.0/packet-modem/tun.hpp:15-73,
//    tun_source.hpp, tun_sink.hpp)
//  - select()-based bounded-latency reads (tun_source.hpp BlockingIO path)
//  - a lock-free SPSC byte ring buffer used by the streaming runtime to
//    decouple the OS ingest thread from the device feeder (the device-side
//    replacement for the GR4 ring-buffer stream edges).
//
// Built as a plain shared library; Python binds via ctypes (io/tun.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <new>
#include <string>
#include <sys/select.h>
#include <sys/stat.h>
#include <sys/time.h>
#include <unistd.h>

#ifdef __linux__
#include <linux/if.h>
#include <linux/if_tun.h>
#include <sched.h>
#include <sys/ioctl.h>
#endif

extern "C" {

// ---------------------------------------------------------------------- TUN

// Open a TUN device (IFF_TUN | IFF_NO_PI). If netns is non-empty, enter that
// named network namespace (like `ip netns`) before opening, restoring the
// original namespace afterwards. Returns fd >= 0 or -errno.
int pm_tun_open(const char* name, const char* netns)
{
#ifndef __linux__
    (void)name;
    (void)netns;
    return -ENOSYS;
#else
    int prev_ns = -1;
    if (netns != nullptr && netns[0] != '\0') {
        std::string path = std::string("/var/run/netns/") + netns;
        prev_ns = open("/proc/self/ns/net", O_RDONLY);
        if (prev_ns < 0) {
            return -errno;
        }
        int ns = open(path.c_str(), O_RDONLY);
        if (ns < 0) {
            int e = errno;
            close(prev_ns);
            return -e;
        }
        if (setns(ns, CLONE_NEWNET) < 0) {
            int e = errno;
            close(ns);
            close(prev_ns);
            return -e;
        }
        close(ns);
    }

    int fd = open("/dev/net/tun", O_RDWR);
    int err = fd < 0 ? errno : 0;
    if (fd >= 0) {
        struct ifreq ifr;
        std::memset(&ifr, 0, sizeof(ifr));
        ifr.ifr_flags = IFF_TUN | IFF_NO_PI;
        std::strncpy(ifr.ifr_name, name, IFNAMSIZ - 1);
        if (ioctl(fd, TUNSETIFF, &ifr) < 0) {
            err = errno;
            close(fd);
            fd = -1;
        }
    }

    if (prev_ns >= 0) {
        // restore the original namespace for this thread
        setns(prev_ns, CLONE_NEWNET);
        close(prev_ns);
    }
    return fd >= 0 ? fd : -err;
#endif
}

// Read one packet with a timeout. Returns n > 0, 0 on timeout, -errno.
int pm_read_timeout(int fd, uint8_t* buf, int cap, int timeout_ms)
{
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(fd, &rfds);
    struct timeval tv;
    tv.tv_sec = timeout_ms / 1000;
    tv.tv_usec = (timeout_ms % 1000) * 1000;
    int ret = select(fd + 1, &rfds, nullptr, nullptr, &tv);
    if (ret < 0) {
        return -errno;
    }
    if (ret == 0) {
        return 0;
    }
    ssize_t n = read(fd, buf, static_cast<size_t>(cap));
    if (n < 0) {
        return -errno;
    }
    return static_cast<int>(n);
}

// Write one packet; tolerates failures like TunSink (tun_sink.hpp:33-37) by
// returning the error instead of raising.
int pm_write(int fd, const uint8_t* buf, int n)
{
    ssize_t ret = write(fd, buf, static_cast<size_t>(n));
    return ret < 0 ? -errno : static_cast<int>(ret);
}

int pm_close(int fd) { return close(fd) < 0 ? -errno : 0; }

// ------------------------------------------------------------ SPSC ring

struct PmRing {
    uint8_t* data;
    size_t capacity; // power of two
    std::atomic<uint64_t> head{ 0 }; // write position
    std::atomic<uint64_t> tail{ 0 }; // read position
};

void* pm_ring_create(size_t capacity_pow2)
{
    size_t cap = 1;
    while (cap < capacity_pow2) {
        cap <<= 1;
    }
    auto* r = new (std::nothrow) PmRing;
    if (r == nullptr) {
        return nullptr;
    }
    r->data = new (std::nothrow) uint8_t[cap];
    if (r->data == nullptr) {
        delete r;
        return nullptr;
    }
    r->capacity = cap;
    return r;
}

void pm_ring_destroy(void* ring)
{
    auto* r = static_cast<PmRing*>(ring);
    delete[] r->data;
    delete r;
}

size_t pm_ring_readable(void* ring)
{
    auto* r = static_cast<PmRing*>(ring);
    return static_cast<size_t>(
        r->head.load(std::memory_order_acquire) -
        r->tail.load(std::memory_order_acquire));
}

size_t pm_ring_writable(void* ring)
{
    auto* r = static_cast<PmRing*>(ring);
    return r->capacity - pm_ring_readable(ring);
}

// Producer side: returns bytes written (may be < n if full).
size_t pm_ring_write(void* ring, const uint8_t* buf, size_t n)
{
    auto* r = static_cast<PmRing*>(ring);
    const uint64_t head = r->head.load(std::memory_order_relaxed);
    const uint64_t tail = r->tail.load(std::memory_order_acquire);
    size_t avail = r->capacity - static_cast<size_t>(head - tail);
    if (n > avail) {
        n = avail;
    }
    const size_t mask = r->capacity - 1;
    for (size_t i = 0; i < n; ++i) {
        r->data[(head + i) & mask] = buf[i];
    }
    r->head.store(head + n, std::memory_order_release);
    return n;
}

// Consumer side: returns bytes read (may be < n if empty).
size_t pm_ring_read(void* ring, uint8_t* buf, size_t n)
{
    auto* r = static_cast<PmRing*>(ring);
    const uint64_t tail = r->tail.load(std::memory_order_relaxed);
    const uint64_t head = r->head.load(std::memory_order_acquire);
    size_t avail = static_cast<size_t>(head - tail);
    if (n > avail) {
        n = avail;
    }
    const size_t mask = r->capacity - 1;
    for (size_t i = 0; i < n; ++i) {
        buf[i] = r->data[(tail + i) & mask];
    }
    r->tail.store(tail + n, std::memory_order_release);
    return n;
}

} // extern "C"
