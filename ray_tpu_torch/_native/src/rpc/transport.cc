// Native RPC transport: epoll engine + versioned binary framing.
//
// Role-equivalent of the reference's rpc layer (src/ray/rpc/ ::
// GrpcServer/ServerCall/ClientCallManager): the hot control-plane path —
// socket ownership, framing, request/reply matching, write batching — runs
// in C++; Python (asyncio) only sees whole decoded messages through a
// single eventfd-notified inbox, instead of per-connection StreamReader
// tasks parsing frames in the interpreter.
//
// Wire format v1 (versioned binary header; typed schema for the envelope,
// msgpack for the payload — the N14 "typed wire schemas" role):
//   [u32 frame_len][u8 ver=1][u8 kind][u32 msgid][u16 method_len]
//   [method bytes][payload bytes]
// frame_len counts ver..payload. Little-endian. kind: 0=REQ 1=REP 2=ERR
// 3=PUSH; synthetic (never on the wire): 254=ACCEPTED 255=CLOSED.
//
// Threading model:
//   * one engine thread per process runs epoll: reads, frame parsing,
//     accepts, deferred writes.
//   * any Python thread may call rt_send(): connection lookup takes the
//     engine map mutex briefly; the write itself runs under the
//     connection's own write mutex (senders never contend with the engine
//     thread's read/parse work). When the queue was empty the frame is
//     written inline from the caller (latency fast path); leftovers are
//     flushed by the engine thread via EPOLLOUT.
//   * decoded messages go to a single inbox (mutex + deque); the Python
//     side waits on an eventfd and drains with rt_next()/rt_msg_free().

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>

namespace raytpu {
namespace rpc {

constexpr uint8_t kVersion = 1;
constexpr uint8_t kReq = 0;
constexpr uint8_t kRep = 1;
constexpr uint8_t kErr = 2;
constexpr uint8_t kPush = 3;
constexpr uint8_t kInjected = 253;  // synthetic: rt_exec_inject wakeup
constexpr uint8_t kAccepted = 254;
constexpr uint8_t kClosed = 255;
constexpr size_t kMaxFrame = 1u << 30;  // 1 GiB sanity bound

// Object-transfer plane tuning (push_manager.cc / object_buffer_pool.cc
// role): chunk size balances frame overhead against write batching; the
// budgets bound memory held by in-flight transfers on each side.
constexpr size_t kObjChunk = 1u << 20;            // 1 MiB per chunk frame
constexpr size_t kOutboundBudget = 256u << 20;    // queued push jobs
constexpr size_t kInboundBudget = 256u << 20;     // reassembly buffers
constexpr size_t kConnBacklogCap = 32u << 20;     // per-conn wq high water

struct Msg {
  long conn = 0;
  uint8_t kind = 0;
  uint32_t msgid = 0;
  std::string method;
  std::vector<uint8_t> payload;
};

// ---------------------------------------------------------------------------
// Minimal msgpack scanning/emission for the native lease lane (the subset
// the generic payload codec produces: maps, str, bin, numbers, bool, nil,
// arrays). Reads by key, skips unknowns — version-skew safe like the
// generated codecs.
// ---------------------------------------------------------------------------
namespace mp {

struct Cur {
  const uint8_t *p;
  const uint8_t *end;
  bool ok = true;
  uint8_t take() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
  }
  uint8_t peek() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p;
  }
  bool need(size_t n) {
    if (size_t(end - p) < n) {
      ok = false;
      return false;
    }
    return true;
  }
  uint64_t be(size_t n) {
    if (!need(n)) return 0;
    uint64_t v = 0;
    for (size_t i = 0; i < n; ++i) v = (v << 8) | *p++;
    return v;
  }
};

inline uint32_t map_header(Cur &c) {
  uint8_t b = c.take();
  if (!c.ok) return 0;
  if ((b & 0xF0) == 0x80) return b & 0x0F;
  if (b == 0xDE) return uint32_t(c.be(2));
  if (b == 0xDF) return uint32_t(c.be(4));
  c.ok = false;
  return 0;
}

inline bool read_str(Cur &c, std::string *out) {
  uint8_t b = c.take();
  if (!c.ok) return false;
  uint32_t n;
  if ((b & 0xE0) == 0xA0) n = b & 0x1F;
  else if (b == 0xD9) n = uint32_t(c.be(1));
  else if (b == 0xDA) n = uint32_t(c.be(2));
  else if (b == 0xDB) n = uint32_t(c.be(4));
  else {
    c.ok = false;
    return false;
  }
  if (!c.need(n)) return false;
  out->assign(reinterpret_cast<const char *>(c.p), n);
  c.p += n;
  return true;
}

inline bool read_number(Cur &c, double *out) {
  uint8_t b = c.take();
  if (!c.ok) return false;
  if (b < 0x80) {
    *out = b;
    return true;
  }
  if (b >= 0xE0) {
    *out = int8_t(b);
    return true;
  }
  switch (b) {
    case 0xCA: {
      uint32_t v = uint32_t(c.be(4));
      float f;
      memcpy(&f, &v, 4);
      *out = f;
      return c.ok;
    }
    case 0xCB: {
      uint64_t v = c.be(8);
      double d;
      memcpy(&d, &v, 8);
      *out = d;
      return c.ok;
    }
    case 0xCC: *out = double(c.be(1)); return c.ok;
    case 0xCD: *out = double(c.be(2)); return c.ok;
    case 0xCE: *out = double(c.be(4)); return c.ok;
    case 0xCF: *out = double(c.be(8)); return c.ok;
    case 0xD0: *out = double(int8_t(c.be(1))); return c.ok;
    case 0xD1: *out = double(int16_t(c.be(2))); return c.ok;
    case 0xD2: *out = double(int32_t(c.be(4))); return c.ok;
    case 0xD3: *out = double(int64_t(c.be(8))); return c.ok;
    default:
      c.ok = false;
      return false;
  }
}

inline bool skip(Cur &c, int depth = 0) {
  if (depth > 32) {
    c.ok = false;
    return false;
  }
  uint8_t b = c.take();
  if (!c.ok) return false;
  if (b < 0x80 || b >= 0xE0) return true;
  if ((b & 0xF0) == 0x80) {
    uint32_t n = b & 0x0F;
    for (uint32_t i = 0; i < 2 * n; ++i)
      if (!skip(c, depth + 1)) return false;
    return true;
  }
  if ((b & 0xF0) == 0x90) {
    uint32_t n = b & 0x0F;
    for (uint32_t i = 0; i < n; ++i)
      if (!skip(c, depth + 1)) return false;
    return true;
  }
  if ((b & 0xE0) == 0xA0) {
    uint32_t n = b & 0x1F;
    if (!c.need(n)) return false;
    c.p += n;
    return true;
  }
  switch (b) {
    case 0xC0:
    case 0xC2:
    case 0xC3:
      return true;
    case 0xC4:
    case 0xD9: {
      uint64_t n = c.be(1);
      if (!c.need(n)) return false;
      c.p += n;
      return true;
    }
    case 0xC5:
    case 0xDA: {
      uint64_t n = c.be(2);
      if (!c.need(n)) return false;
      c.p += n;
      return true;
    }
    case 0xC6:
    case 0xDB: {
      uint64_t n = c.be(4);
      if (!c.need(n)) return false;
      c.p += n;
      return true;
    }
    case 0xCA: return c.need(4) && (c.p += 4, true);
    case 0xCB: return c.need(8) && (c.p += 8, true);
    case 0xCC:
    case 0xD0: return c.need(1) && (c.p += 1, true);
    case 0xCD:
    case 0xD1: return c.need(2) && (c.p += 2, true);
    case 0xCE:
    case 0xD2: return c.need(4) && (c.p += 4, true);
    case 0xCF:
    case 0xD3: return c.need(8) && (c.p += 8, true);
    case 0xDC: {
      uint64_t n = c.be(2);
      for (uint64_t i = 0; i < n; ++i)
        if (!skip(c, depth + 1)) return false;
      return true;
    }
    case 0xDD: {
      uint64_t n = c.be(4);
      for (uint64_t i = 0; i < n; ++i)
        if (!skip(c, depth + 1)) return false;
      return true;
    }
    case 0xDE: {
      uint64_t n = c.be(2);
      for (uint64_t i = 0; i < 2 * n; ++i)
        if (!skip(c, depth + 1)) return false;
      return true;
    }
    case 0xDF: {
      uint64_t n = c.be(4);
      for (uint64_t i = 0; i < 2 * n; ++i)
        if (!skip(c, depth + 1)) return false;
      return true;
    }
    default:
      c.ok = false;
      return false;
  }
}

inline void emit_str(std::string &out, const std::string &s) {
  size_t n = s.size();
  if (n < 32) {
    out.push_back(char(0xA0 | n));
  } else if (n < 256) {
    out.push_back(char(0xD9));
    out.push_back(char(n));
  } else {
    out.push_back(char(0xDA));
    out.push_back(char(n >> 8));
    out.push_back(char(n));
  }
  out.append(s);
}

inline void emit_uint(std::string &out, uint64_t v) {
  if (v < 128) {
    out.push_back(char(v));
  } else if (v < 256) {
    out.push_back(char(0xCC));
    out.push_back(char(v));
  } else if (v < 65536) {
    out.push_back(char(0xCD));
    out.push_back(char(v >> 8));
    out.push_back(char(v));
  } else {
    out.push_back(char(0xCE));
    out.push_back(char(v >> 24));
    out.push_back(char(v >> 16));
    out.push_back(char(v >> 8));
    out.push_back(char(v));
  }
}

}  // namespace mp

struct Conn {
  long id = 0;
  bool listener = false;
  bool unix_listener = false;
  std::string unix_path;  // for unlink on close (listeners)

  // Read state: touched ONLY by the engine thread.
  std::vector<uint8_t> rbuf;
  size_t rstart = 0;

  // Write state + fd validity: guarded by wmu.
  std::mutex wmu;
  int fd = -1;
  std::deque<std::vector<uint8_t>> wq;
  size_t woff = 0;
  bool closed = false;
  // An EPOLLOUT arm request for this conn is already queued with the
  // engine thread: bursting senders skip the per-frame eventfd wake
  // (one syscall + engine-thread preemption per frame, measured the
  // dominant submit cost on 1-core hosts).
  bool arm_pending = false;

  std::atomic<uint32_t> next_msgid{0};
};

class Engine {
 public:
  Engine() {
    epfd_ = epoll_create1(EPOLL_CLOEXEC);
    wakefd_ = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
    notifyfd_ = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = 0;  // 0 = wake fd
    epoll_ctl(epfd_, EPOLL_CTL_ADD, wakefd_, &ev);
    running_ = true;
    thread_ = std::thread([this] { Loop(); });
  }

  ~Engine() {
    Stop();
    // Free replies nobody collected (callers must not be blocked in
    // CallWait past Stop — the Python engine wrapper guarantees it).
    std::lock_guard<std::mutex> lock(call_mu_);
    for (auto &kv : calls_) delete kv.second.reply;
    calls_.clear();
  }

  void Stop() {
    bool expected = true;
    if (!running_.compare_exchange_strong(expected, false)) return;
    Wake();
    if (thread_.joinable()) thread_.join();
    {
      std::lock_guard<std::mutex> lock(push_mu_);
      push_cv_.notify_all();
    }
    if (push_thread_.joinable()) push_thread_.join();
    {
      std::lock_guard<std::mutex> lock(mu_);
      for (auto &kv : conns_) CloseFd(*kv.second);
      conns_.clear();
      close(epfd_);
      close(wakefd_);
      close(notifyfd_);
      for (auto *m : inbox_) delete m;
      inbox_.clear();
    }
    {
      // Fail every parked native call, then WAIT for the waiters to
      // drain: a thread still inside CallWait/ExecNext when the engine
      // is deleted would wake on a destroyed mutex (TSAN-caught).
      std::unique_lock<std::mutex> lock(call_mu_);
      for (auto &kv : calls_) {
        if (kv.second.state == 0) kv.second.state = 2;
      }
      conn_calls_.clear();
      call_cv_.notify_all();
      call_cv_.wait(lock, [&] { return call_waiters_ == 0; });
    }
    {
      std::unique_lock<std::mutex> lock(exec_mu_);
      for (auto *m : execq_) delete m;
      execq_.clear();
      exec_cv_.notify_all();
      exec_cv_.wait(lock, [&] { return exec_waiters_ == 0; });
    }
  }

  int notify_fd() const { return notifyfd_; }

  long ConnectTcp(const char *host, int port) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return -errno;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(uint16_t(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      close(fd);
      return -EINVAL;
    }
    if (connect(fd, (sockaddr *)&addr, sizeof(addr)) != 0) {
      int err = errno;
      close(fd);
      return -err;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    return Register(fd, /*listener=*/false);
  }

  long ConnectUnix(const char *path) {
    int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return -errno;
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", path);
    if (connect(fd, (sockaddr *)&addr, sizeof(addr)) != 0) {
      int err = errno;
      close(fd);
      return -err;
    }
    return Register(fd, /*listener=*/false);
  }

  long ListenTcp(const char *host, int port, int *out_port) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return -errno;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(uint16_t(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      close(fd);
      return -EINVAL;
    }
    if (bind(fd, (sockaddr *)&addr, sizeof(addr)) != 0 ||
        listen(fd, 512) != 0) {
      int err = errno;
      close(fd);
      return -err;
    }
    if (out_port) {
      socklen_t len = sizeof(addr);
      getsockname(fd, (sockaddr *)&addr, &len);
      *out_port = ntohs(addr.sin_port);
    }
    return Register(fd, /*listener=*/true);
  }

  long ListenUnix(const char *path) {
    int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (fd < 0) return -errno;
    ::unlink(path);
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", path);
    if (bind(fd, (sockaddr *)&addr, sizeof(addr)) != 0 ||
        listen(fd, 512) != 0) {
      int err = errno;
      close(fd);
      return -err;
    }
    long id = Register(fd, /*listener=*/true);
    if (id > 0) {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = conns_.find(id);
      if (it != conns_.end()) {
        it->second->unix_listener = true;
        it->second->unix_path = path;
      }
    }
    return id;
  }

  uint32_t NextMsgid(long conn_id) {
    auto conn = Lookup(conn_id);
    if (!conn) return 0;
    uint32_t id = ++conn->next_msgid;
    if (id == 0) id = ++conn->next_msgid;  // skip 0 (reserved)
    return id;
  }

  // Debug probe: fills a 6-slot array (wq/woff/fd/closed/bytes/rbuf).
  int ConnDebug(long conn_id, long long *out) {
    auto conn = Lookup(conn_id);
    if (!conn) return -1;
    std::lock_guard<std::mutex> wlock(conn->wmu);
    out[0] = (long long)conn->wq.size();
    out[1] = (long long)conn->woff;
    out[2] = (long long)conn->fd;
    out[3] = conn->closed ? 1 : 0;
    long long bytes = 0;
    for (auto &f : conn->wq) bytes += (long long)f.size();
    out[4] = bytes;
    // Unparsed inbound bytes: nonzero at idle means a framing desync —
    // ParseFrames is waiting on a frame length that will never arrive.
    out[5] = (long long)(conn->rbuf.size() - conn->rstart);
    return 0;
  }

  // All live conn ids (debug).
  int ListConns(long long *out, int cap) {
    std::lock_guard<std::mutex> lock(mu_);
    int n = 0;
    for (auto &kv : conns_) {
      if (n >= cap) break;
      out[n++] = kv.first;
    }
    return n;
  }

  // Build + send a frame. Returns 0 on success, <0 on error.
  // allow_inline=false defers the socket write to the engine thread: a
  // bursting (GIL-holding) submitter then pays only a memcpy + one
  // eventfd wake, and the engine coalesces queued frames with writev —
  // instead of one ::send syscall (plus a scheduler preemption to the
  // woken peer, measured ~120us on 1-core hosts) per frame.
  int Send(long conn_id, uint8_t kind, uint32_t msgid, const uint8_t *method,
           uint32_t mlen, const uint8_t *payload, uint32_t plen,
           bool allow_inline = true) {
    if (mlen > 0xFFFF) return -EINVAL;
    auto conn = Lookup(conn_id);
    if (!conn) return -ENOTCONN;
    uint32_t body = 1 + 1 + 4 + 2 + mlen + plen;
    std::vector<uint8_t> frame(4 + body);
    uint8_t *p = frame.data();
    memcpy(p, &body, 4);
    p[4] = kVersion;
    p[5] = kind;
    memcpy(p + 6, &msgid, 4);
    uint16_t ml = uint16_t(mlen);
    memcpy(p + 10, &ml, 2);
    if (mlen) memcpy(p + 12, method, mlen);
    if (plen) memcpy(p + 12 + mlen, payload, plen);

    bool need_arm = false;
    const long long fbytes = (long long)frame.size();
    {
      std::lock_guard<std::mutex> wlock(conn->wmu);
      if (conn->closed || conn->fd < 0) return -ENOTCONN;
      if (allow_inline && conn->wq.empty()) {
        // Fast path: write inline from the caller thread.
        ssize_t n = ::send(conn->fd, frame.data(), frame.size(), MSG_NOSIGNAL);
        if (n == ssize_t(frame.size())) {
          frames_sent_.fetch_add(1, std::memory_order_relaxed);
          bytes_sent_.fetch_add(fbytes, std::memory_order_relaxed);
          return 0;
        }
        if (n < 0) {
          if (errno != EAGAIN && errno != EWOULDBLOCK) {
            RequestClose(conn_id);
            return -ECONNRESET;
          }
          n = 0;
        }
        conn->woff = 0;
        frame.erase(frame.begin(), frame.begin() + n);
        conn->wq.push_back(std::move(frame));
      } else {
        conn->wq.push_back(std::move(frame));
      }
      // Arm EPOLLOUT once per burst: if a previous frame's arm request
      // is still queued with the engine thread, this frame rides it.
      if (!conn->arm_pending) {
        conn->arm_pending = true;
        need_arm = true;
      }
    }
    if (need_arm) {
      std::lock_guard<std::mutex> lock(mu_);
      pending_arm_.push_back(conn_id);
      Wake();
    }
    // Queued frames count as sent at enqueue time: the observable quantity
    // is engine throughput, and the residue is visible as write_queue depth.
    frames_sent_.fetch_add(1, std::memory_order_relaxed);
    bytes_sent_.fetch_add(fbytes, std::memory_order_relaxed);
    return 0;
  }

  void CloseConn(long conn_id) { RequestClose(conn_id); }

  // Dequeue one message. Returns the Msg* (caller frees via rt_msg_free)
  // or nullptr when empty.
  Msg *Next() {
    std::lock_guard<std::mutex> lock(mu_);
    if (inbox_.empty()) return nullptr;
    Msg *m = inbox_.front();
    inbox_.pop_front();
    return m;
  }

  // -------------------------------------------------------------------
  // Native call table — request/reply matching in C++ (the reference's
  // ClientCallManager / task-reply matching role, N18/N19): callers on
  // ANY thread start a call and block in CallWait with the GIL released;
  // the engine thread captures the matching REP/ERR before it ever
  // reaches the Python inbox. Shares msgid space with the asyncio
  // clients on the same conn, so both styles coexist per connection.
  // -------------------------------------------------------------------
  struct PendingCall {
    long conn = 0;
    uint32_t msgid = 0;
    int state = 0;  // 0=waiting 1=done 2=conn-lost
    Msg *reply = nullptr;
  };

  uint64_t CallStart(long conn_id, const uint8_t *method, uint32_t mlen,
                     const uint8_t *payload, uint32_t plen,
                     bool allow_inline = true) {
    uint32_t msgid = NextMsgid(conn_id);
    if (msgid == 0) return 0;
    uint64_t handle;
    {
      std::lock_guard<std::mutex> lock(call_mu_);
      handle = next_call_++;
      PendingCall &pc = calls_[handle];
      pc.conn = conn_id;
      pc.msgid = msgid;
      conn_calls_[conn_id][msgid] = handle;
    }
    int rc = Send(conn_id, kReq, msgid, method, mlen, payload, plen,
                  allow_inline);
    if (rc != 0) {
      std::lock_guard<std::mutex> lock(call_mu_);
      calls_.erase(handle);
      auto it = conn_calls_.find(conn_id);
      if (it != conn_calls_.end()) it->second.erase(msgid);
      return 0;
    }
    return handle;
  }

  // 1 = reply ready (view filled, caller owns reply via rt_msg_free),
  // 0 = timeout, -1 = connection lost, -2 = unknown handle.
  int CallWait(uint64_t handle, int timeout_ms, Msg **out) {
    std::unique_lock<std::mutex> lock(call_mu_);
    auto it = calls_.find(handle);
    if (it == calls_.end()) return -2;
    if (it->second.state == 0) {
      auto pred = [&] {
        auto i = calls_.find(handle);
        return i == calls_.end() || i->second.state != 0;
      };
      ++call_waiters_;
      bool satisfied = true;
      if (timeout_ms < 0) {
        call_cv_.wait(lock, pred);
      } else {
        satisfied = call_cv_.wait_for(
            lock, std::chrono::milliseconds(timeout_ms), pred);
      }
      if (--call_waiters_ == 0 && !running_.load()) {
        call_cv_.notify_all();  // release a Stop() draining waiters
      }
      if (!satisfied) return 0;
      it = calls_.find(handle);
      if (it == calls_.end()) return -2;
    }
    int state = it->second.state;
    if (state == 0) return 0;
    *out = it->second.reply;  // may be nullptr on conn-lost
    calls_.erase(it);
    return state == 1 ? 1 : -1;
  }

  // Non-blocking probe; same returns as CallWait (0 = still pending).
  int CallPoll(uint64_t handle, Msg **out) {
    std::lock_guard<std::mutex> lock(call_mu_);
    auto it = calls_.find(handle);
    if (it == calls_.end()) return -2;
    if (it->second.state == 0) return 0;
    *out = it->second.reply;
    int state = it->second.state;
    calls_.erase(it);
    return state == 1 ? 1 : -1;
  }

  void CallAbandon(uint64_t handle) {
    std::lock_guard<std::mutex> lock(call_mu_);
    auto it = calls_.find(handle);
    if (it == calls_.end()) return;
    delete it->second.reply;
    auto cit = conn_calls_.find(it->second.conn);
    if (cit != conn_calls_.end()) cit->second.erase(it->second.msgid);
    calls_.erase(it);
  }

  // -------------------------------------------------------------------
  // Exec queue — the worker-side fast lane (task_receiver.cc role, N20):
  // REQ frames whose method is in the filter set bypass the Python inbox
  // (and thus the asyncio loop) and land in a dedicated queue consumed
  // by the worker's execution thread via ExecNext (GIL released while
  // blocked). ExecInject lets Python enqueue its own work items so one
  // thread serves both lanes in arrival order.
  // -------------------------------------------------------------------
  void ExecFilterAdd(const char *method) {
    std::lock_guard<std::mutex> lock(exec_mu_);
    exec_methods_.insert(method);
    exec_filter_on_.store(true, std::memory_order_release);
  }

  int ExecNext(int timeout_ms, Msg **out) {
    std::unique_lock<std::mutex> lock(exec_mu_);
    auto pred = [&] { return !execq_.empty() || !running_.load(); };
    ++exec_waiters_;
    bool satisfied = true;
    if (timeout_ms < 0) {
      exec_cv_.wait(lock, pred);
    } else {
      satisfied =
          exec_cv_.wait_for(lock, std::chrono::milliseconds(timeout_ms), pred);
    }
    if (--exec_waiters_ == 0 && !running_.load()) {
      exec_cv_.notify_all();  // release a Stop() draining waiters
    }
    if (!satisfied) return 0;
    if (!execq_.empty()) {
      *out = execq_.front();
      execq_.pop_front();
      return 1;
    }
    return -1;  // engine stopping
  }

  void ExecInject(uint32_t tag) {
    auto *m = new Msg();
    m->kind = kInjected;
    m->msgid = tag;
    std::lock_guard<std::mutex> lock(exec_mu_);
    execq_.push_back(m);
    exec_cv_.notify_one();
  }

  int ExecPending() {
    std::lock_guard<std::mutex> lock(exec_mu_);
    return int(execq_.size());
  }

  // Native calls on `conn` still awaiting a reply (entries leave the map
  // the moment the engine captures the reply): the TRUE in-flight depth,
  // unlike any Python-side uncollected counter.
  int ConnInflight(long conn_id) {
    std::lock_guard<std::mutex> lock(call_mu_);
    auto it = conn_calls_.find(conn_id);
    return it == conn_calls_.end() ? 0 : int(it->second.size());
  }

  // -------------------------------------------------------------------
  // Object-transfer plane (src/ray/object_manager/{push_manager,
  // object_buffer_pool}.cc role): whole objects move between nodes as
  // obj_chunk PUSH frames sliced and reassembled entirely in C++ — the
  // Python side sees ONE obj_complete message per object, never a
  // per-chunk callback. A dedicated sender thread paces chunks against
  // the connection's write backlog; byte budgets bound both pools.
  // -------------------------------------------------------------------
  struct PushJob {
    long conn;
    std::string oid;
    std::string data;
  };

  struct InboundTransfer {
    std::string data;
    size_t received = 0;
    std::chrono::steady_clock::time_point last_update;
  };

  // Queue one object for push. 0 = accepted; -1 = over budget (caller
  // falls back to the pull path); -2 = engine stopping.
  int PushObject(long conn_id, const char *oid, const uint8_t *data,
                 uint64_t len) {
    std::lock_guard<std::mutex> lock(push_mu_);
    if (!running_.load()) return -2;
    if (outbound_bytes_ + len > kOutboundBudget) return -1;
    outbound_bytes_ += len;
    push_jobs_.push_back(
        PushJob{conn_id, std::string(oid),
                std::string(reinterpret_cast<const char *>(data), len)});
    if (!push_thread_.joinable()) {
      push_thread_ = std::thread([this] { PushLoop(); });
    }
    push_cv_.notify_one();
    return 0;
  }

  // Hand a completed inbound transfer's buffer to the caller (valid
  // until TransferFree). 0 = ok, -1 = unknown/incomplete.
  int TransferTake(const char *oid, const uint8_t **ptr, uint64_t *len) {
    std::lock_guard<std::mutex> lock(xfer_mu_);
    auto it = completed_.find(oid);
    if (it == completed_.end()) return -1;
    *ptr = reinterpret_cast<const uint8_t *>(it->second.data());
    *len = it->second.size();
    return 0;
  }

  void TransferFree(const char *oid) {
    std::lock_guard<std::mutex> lock(xfer_mu_);
    auto it = completed_.find(oid);
    if (it != completed_.end()) {
      inbound_bytes_ -= it->second.size();
      completed_.erase(it);
    }
  }

 private:
  void PushLoop() {
    while (true) {
      PushJob job;
      {
        std::unique_lock<std::mutex> lock(push_mu_);
        push_cv_.wait(lock, [&] {
          return !push_jobs_.empty() || !running_.load();
        });
        if (!running_.load()) return;
        job = std::move(push_jobs_.front());
        push_jobs_.pop_front();
      }
      SendObject(job);
      {
        std::lock_guard<std::mutex> lock(push_mu_);
        outbound_bytes_ -= job.data.size();
      }
    }
  }

  // Slice one object into obj_chunk frames. Payload layout:
  // [u16 oid_len][oid][u64 offset][u64 total][chunk bytes].
  void SendObject(const PushJob &job) {
    const uint64_t total = job.data.size();
    uint64_t offset = 0;
    do {
      uint64_t n = std::min<uint64_t>(kObjChunk, total - offset);
      std::string payload;
      payload.reserve(2 + job.oid.size() + 16 + n);
      uint16_t oid_len = uint16_t(job.oid.size());
      payload.append(reinterpret_cast<const char *>(&oid_len), 2);
      payload.append(job.oid);
      payload.append(reinterpret_cast<const char *>(&offset), 8);
      payload.append(reinterpret_cast<const char *>(&total), 8);
      payload.append(job.data.data() + offset, n);
      // Pace against the conn's write backlog so one huge object cannot
      // balloon the write queue (the buffer-pool bound on this side).
      for (int spin = 0; running_.load() && spin < 5000; ++spin) {
        long long dbg[6];
        if (ConnDebug(job.conn, dbg) != 0) return;  // conn gone: abort
        if (size_t(dbg[4]) < kConnBacklogCap) break;
        std::this_thread::sleep_for(std::chrono::milliseconds(2));
      }
      if (!running_.load()) return;
      int rc = Send(job.conn, kPush, 0,
                    reinterpret_cast<const uint8_t *>("obj_chunk"), 9,
                    reinterpret_cast<const uint8_t *>(payload.data()),
                    uint32_t(payload.size()),
                    /*allow_inline=*/false);
      if (rc != 0) return;  // conn closed mid-transfer: receiver times out
      chunks_sent_.fetch_add(1, std::memory_order_relaxed);
      offset += n;
    } while (offset < total);
  }

  // Engine thread: absorb one obj_chunk frame into the reassembly pool;
  // returns the completion Msg to enqueue (or nullptr). In-flight
  // transfers are keyed by (conn, oid): two senders can never interleave
  // into one buffer, and an offset-0 chunk on an existing entry means
  // the SAME sender restarted an aborted push (per-conn FIFO ordering),
  // so the entry resets instead of double-counting.
  Msg *HandleObjChunk(Msg *m) {
    const uint8_t *p = m->payload.data();
    size_t len = m->payload.size();
    if (len < 18) {
      delete m;
      return nullptr;
    }
    uint16_t oid_len;
    memcpy(&oid_len, p, 2);
    if (size_t(2 + oid_len + 16) > len) {
      delete m;
      return nullptr;
    }
    std::string oid(reinterpret_cast<const char *>(p + 2), oid_len);
    uint64_t offset, total;
    memcpy(&offset, p + 2 + oid_len, 8);
    memcpy(&total, p + 2 + oid_len + 8, 8);
    const uint8_t *chunk = p + 2 + oid_len + 16;
    size_t chunk_len = len - 2 - oid_len - 16;
    std::string key = std::to_string(m->conn) + "#" + oid;
    bool done = false;
    {
      std::lock_guard<std::mutex> lock(xfer_mu_);
      auto it = inbound_.find(key);
      if (it != inbound_.end() && offset == 0 && it->second.received > 0) {
        // aborted attempt restarted on the same conn: start clean
        it->second.received = 0;
      }
      if (it == inbound_.end()) {
        if (inbound_bytes_ + total > kInboundBudget || total > kMaxFrame) {
          delete m;  // over budget: drop; the pull path still works
          return nullptr;
        }
        inbound_bytes_ += total;
        it = inbound_.emplace(key, InboundTransfer{}).first;
        it->second.data.resize(total);
      }
      InboundTransfer &t = it->second;
      if (offset + chunk_len > t.data.size()) {
        delete m;
        return nullptr;
      }
      memcpy(&t.data[offset], chunk, chunk_len);
      t.received += chunk_len;
      chunks_recv_.fetch_add(1, std::memory_order_relaxed);
      t.last_update = std::chrono::steady_clock::now();
      if (t.received >= t.data.size()) {
        // move to the completed pool (keyed by oid alone — TransferTake's
        // namespace); budget charge follows the bytes
        completed_[oid] = std::move(t.data);
        inbound_.erase(it);
        done = true;
      }
    }
    long conn = m->conn;
    delete m;
    if (!done) return nullptr;
    auto *note = new Msg();
    note->conn = conn;
    note->kind = kPush;
    note->method = "obj_complete";
    note->payload.assign(oid.begin(), oid.end());
    return note;
  }

  // Engine thread, called from the loop's idle tick: evict in-flight
  // transfers that stopped making progress (aborted senders) so their
  // budget charge is refunded — without this, aborted pushes would
  // permanently consume the inbound budget and silently disable the
  // push plane.
  void SweepStaleTransfers() {
    auto now = std::chrono::steady_clock::now();
    std::lock_guard<std::mutex> lock(xfer_mu_);
    for (auto it = inbound_.begin(); it != inbound_.end();) {
      if (now - it->second.last_update > std::chrono::seconds(60)) {
        inbound_bytes_ -= it->second.data.size();
        it = inbound_.erase(it);
      } else {
        ++it;
      }
    }
  }

  std::mutex push_mu_;  // push_jobs_, outbound_bytes_, push_thread_ start
  std::condition_variable push_cv_;
  std::deque<PushJob> push_jobs_;
  size_t outbound_bytes_ = 0;
  std::thread push_thread_;
  std::mutex xfer_mu_;  // inbound_, completed_, inbound_bytes_
  std::unordered_map<std::string, InboundTransfer> inbound_;  // (conn#oid)
  std::unordered_map<std::string, std::string> completed_;    // oid -> data
  size_t inbound_bytes_ = 0;

 public:
  // -------------------------------------------------------------------
  // Native lease lane (raylet local_task_manager.cc /
  // cluster_resource_scheduler.cc grant path, N9/N10): when enabled by
  // the node agent, simple worker-lease requests (default runtime env,
  // no placement-group bundle) are granted and replied to ON THE ENGINE
  // THREAD — resource accounting, idle-pool pop, reply encode — with
  // zero asyncio involvement per lease. Anything else (spawn needed,
  // bundles, custom envs, contention) falls through to the Python
  // handler unchanged; scheduling *policy* stays Python-pluggable.
  // The availability table is the single source of truth while enabled:
  // Python's slow paths adjust it through LeaseAdjust.
  // -------------------------------------------------------------------
  struct IdleWorker {
    std::string worker_id;
    std::string job_id;
    std::string host;
    int port = 0;
  };

  void LeaseEnable(int on) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    lease_on_ = (on != 0);
    lease_fast_.store(lease_on_, std::memory_order_release);
  }

  // Atomically apply name/delta pairs. check!=0: apply only if every
  // resulting value stays >= -1e-9 (grant-style consume); returns 1 on
  // success, 0 if the check failed.
  int LeaseAdjust(const char *names, const double *deltas, int n,
                  int check) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    const char *p = names;
    std::vector<std::string> keys;
    keys.reserve(n);
    for (int i = 0; i < n; ++i) {
      keys.emplace_back(p);
      p += keys.back().size() + 1;
    }
    if (check) {
      for (int i = 0; i < n; ++i) {
        if (deltas[i] < 0 &&
            lease_avail_[keys[i]] + deltas[i] < -1e-9) {
          return 0;
        }
      }
    }
    for (int i = 0; i < n; ++i) lease_avail_[keys[i]] += deltas[i];
    return 1;
  }

  void LeasePoolPut(const char *worker_id, const char *job_id,
                    const char *host, int port) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    lease_idle_.push_back(IdleWorker{worker_id, job_id, host, port});
  }

  int LeasePoolPop(const char *job_id, char *out, int cap) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    for (auto it = lease_idle_.begin(); it != lease_idle_.end(); ++it) {
      if (it->job_id == job_id) {
        snprintf(out, cap, "%s", it->worker_id.c_str());
        lease_idle_.erase(it);
        return 1;
      }
    }
    return 0;
  }

  int LeasePoolRemove(const char *worker_id) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    for (auto it = lease_idle_.begin(); it != lease_idle_.end(); ++it) {
      if (it->worker_id == worker_id) {
        lease_idle_.erase(it);
        return 1;
      }
    }
    return 0;
  }

  // Mark a worker unpoolable (Python's death_reason invariant: a dying
  // worker must never be handed out again). The engine's return path
  // drops banned workers instead of re-pooling them.
  void LeaseWorkerBan(const char *worker_id) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    lease_banned_.insert(worker_id);
    for (auto it = lease_idle_.begin(); it != lease_idle_.end(); ++it) {
      if (it->worker_id == worker_id) {
        lease_idle_.erase(it);
        break;
      }
    }
  }

  void LeaseWorkerUnban(const char *worker_id) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    lease_banned_.erase(worker_id);
  }

  int LeaseForget(const char *lease_id) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    return lease_active_.erase(lease_id) ? 1 : 0;
  }

  // Drain one reconciliation event (JSON line) into buf; 0 = none.
  int LeaseNextEvent(char *buf, int cap) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    if (lease_events_.empty()) return 0;
    const std::string &ev = lease_events_.front();
    int n = int(std::min(size_t(cap - 1), ev.size()));
    memcpy(buf, ev.data(), n);
    buf[n] = 0;
    lease_events_.pop_front();
    return n;
  }

  int LeaseAvailableJson(char *buf, int cap) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    std::string out = "{";
    bool first = true;
    for (auto &kv : lease_avail_) {
      if (!first) out += ",";
      first = false;
      out += "\"" + kv.first + "\":" + std::to_string(kv.second);
    }
    out += "}";
    int n = int(std::min(size_t(cap - 1), out.size()));
    memcpy(buf, out.data(), n);
    buf[n] = 0;
    return n;
  }

  void LeaseStats(long long *out) {
    std::lock_guard<std::mutex> lock(lease_mu_);
    out[0] = lease_grants_;
    out[1] = lease_returns_;
    out[2] = (long long)lease_idle_.size();
    out[3] = (long long)lease_active_.size();
  }

  // 12-slot stats vector consumed by _NativeEngine.stats() in rpc.py:
  // [frames_sent, frames_received, bytes_sent, bytes_received,
  //  chunks_sent, chunks_received, inbox_depth, exec_queue_depth,
  //  write_queue_frames, connections, lease_grants, calls_inflight].
  // Conn write queues are sampled AFTER releasing mu_ (Send holds wmu
  // while calling RequestClose→mu_, so mu_→wmu here would be ABBA).
  void EngineStats(long long *out) {
    out[0] = frames_sent_.load(std::memory_order_relaxed);
    out[1] = frames_recv_.load(std::memory_order_relaxed);
    out[2] = bytes_sent_.load(std::memory_order_relaxed);
    out[3] = bytes_recv_.load(std::memory_order_relaxed);
    out[4] = chunks_sent_.load(std::memory_order_relaxed);
    out[5] = chunks_recv_.load(std::memory_order_relaxed);
    std::vector<std::shared_ptr<Conn>> snap;
    {
      std::lock_guard<std::mutex> lock(mu_);
      out[6] = (long long)inbox_.size();
      out[9] = (long long)conns_.size();
      snap.reserve(conns_.size());
      for (auto &kv : conns_) snap.push_back(kv.second);
    }
    long long wq = 0;
    for (auto &c : snap) {
      std::lock_guard<std::mutex> wlock(c->wmu);
      wq += (long long)c->wq.size();
    }
    out[8] = wq;
    {
      std::lock_guard<std::mutex> lock(exec_mu_);
      out[7] = (long long)execq_.size();
    }
    {
      std::lock_guard<std::mutex> lock(lease_mu_);
      out[10] = lease_grants_;
    }
    {
      std::lock_guard<std::mutex> lock(call_mu_);
      out[11] = (long long)calls_.size();
    }
  }

 private:
  struct ActiveLease {
    std::string worker_id;
    std::string job_id;
    std::string host;
    int port = 0;
    std::vector<std::pair<std::string, double>> resources;
  };

  struct LeaseScan {
    std::vector<std::pair<std::string, double>> resources;
    std::string job_id;
    bool env_empty = true;     // runtime_env absent or {}
    bool bundle_empty = true;  // bundle absent or nil
    bool parse_ok = false;
  };

  static void ScanLeaseRequest(const uint8_t *data, size_t len,
                               LeaseScan *out) {
    mp::Cur c{data, data + len};
    uint32_t n = mp::map_header(c);
    if (!c.ok) return;
    for (uint32_t i = 0; i < n && c.ok; ++i) {
      std::string key;
      if (!mp::read_str(c, &key)) return;
      if (key == "resources") {
        uint32_t rn = mp::map_header(c);
        if (!c.ok) return;
        for (uint32_t r = 0; r < rn; ++r) {
          std::string name;
          double value;
          if (!mp::read_str(c, &name) || !mp::read_number(c, &value))
            return;
          out->resources.emplace_back(std::move(name), value);
        }
      } else if (key == "job_id") {
        if (!mp::read_str(c, &out->job_id)) return;
      } else if (key == "runtime_env") {
        if (c.peek() == 0xC0) {
          c.take();
        } else if (c.peek() == 0x80) {
          c.take();
        } else {
          out->env_empty = false;
          if (!mp::skip(c)) return;
        }
      } else if (key == "bundle") {
        if (c.peek() == 0xC0) {
          c.take();
        } else {
          out->bundle_empty = false;
          if (!mp::skip(c)) return;
        }
      } else {
        if (!mp::skip(c)) return;
      }
    }
    out->parse_ok = c.ok;
  }

  static std::string JsonEscape(const std::string &s) {
    std::string out;
    for (char ch : s) {
      if (ch == '"' || ch == '\\') out.push_back('\\');
      out.push_back(ch);
    }
    return out;
  }

  // Engine thread: try to grant/return natively. True = handled (reply
  // sent, msg freed; *note may carry a lease_freed push for Python's
  // resource waiters); false = fall through to the Python handler.
  bool TryLeaseFast(Msg *m, Msg **note) {
    if (m->method == "lease_worker") {
      LeaseScan scan;
      ScanLeaseRequest(m->payload.data(), m->payload.size(), &scan);
      if (!scan.parse_ok || !scan.env_empty || !scan.bundle_empty) {
        return false;
      }
      std::string reply;
      {
        std::lock_guard<std::mutex> lock(lease_mu_);
        if (!lease_on_) return false;
        // all-or-nothing resource check
        for (auto &kv : scan.resources) {
          if (kv.second > 0 &&
              lease_avail_[kv.first] + 1e-9 < kv.second) {
            return false;  // Python path waits / reports busy
          }
        }
        // job-matched idle worker
        auto it = lease_idle_.begin();
        for (; it != lease_idle_.end(); ++it) {
          if (it->job_id == scan.job_id) break;
        }
        if (it == lease_idle_.end()) return false;  // spawn path
        for (auto &kv : scan.resources) {
          if (kv.second > 0) lease_avail_[kv.first] -= kv.second;
        }
        IdleWorker w = *it;
        lease_idle_.erase(it);
        std::string lease_id = "nlease-" + std::to_string(next_lease_++);
        ActiveLease lease;
        lease.worker_id = w.worker_id;
        lease.job_id = scan.job_id;
        lease.host = w.host;
        lease.port = w.port;
        lease.resources = scan.resources;
        lease_active_[lease_id] = lease;
        ++lease_grants_;
        // reconciliation event for the Python agent
        std::string ev = "{\"ev\":\"grant\",\"lease_id\":\"" + lease_id +
                         "\",\"worker_id\":\"" + JsonEscape(w.worker_id) +
                         "\",\"resources\":{";
        bool first = true;
        for (auto &kv : scan.resources) {
          if (!first) ev += ",";
          first = false;
          ev += "\"" + JsonEscape(kv.first) +
                "\":" + std::to_string(kv.second);
        }
        ev += "}}";
        if (lease_events_.size() < 10000) lease_events_.push_back(ev);
        // reply: {status, lease_id, worker_id, worker_addr:[host, port]}
        reply.push_back(char(0x84));
        mp::emit_str(reply, "status");
        mp::emit_str(reply, "ok");
        mp::emit_str(reply, "lease_id");
        mp::emit_str(reply, lease_id);
        mp::emit_str(reply, "worker_id");
        mp::emit_str(reply, w.worker_id);
        mp::emit_str(reply, "worker_addr");
        reply.push_back(char(0x92));
        mp::emit_str(reply, w.host);
        mp::emit_uint(reply, uint64_t(w.port));
      }
      Send(m->conn, kRep, m->msgid,
           reinterpret_cast<const uint8_t *>(m->method.data()),
           uint32_t(m->method.size()),
           reinterpret_cast<const uint8_t *>(reply.data()),
           uint32_t(reply.size()));
      delete m;
      return true;
    }
    if (m->method == "return_worker") {
      // parse {lease_id, reusable}
      mp::Cur c{m->payload.data(), m->payload.data() + m->payload.size()};
      uint32_t n = mp::map_header(c);
      if (!c.ok) return false;
      std::string lease_id;
      bool reusable = true;
      for (uint32_t i = 0; i < n && c.ok; ++i) {
        std::string key;
        if (!mp::read_str(c, &key)) return false;
        if (key == "lease_id") {
          if (!mp::read_str(c, &lease_id)) return false;
        } else if (key == "reusable") {
          uint8_t b = c.take();
          if (b == 0xC2) reusable = false;
          else if (b != 0xC3) return false;
        } else {
          if (!mp::skip(c)) return false;
        }
      }
      if (!c.ok || lease_id.empty() || !reusable) return false;
      {
        std::lock_guard<std::mutex> lock(lease_mu_);
        if (!lease_on_) return false;
        auto it = lease_active_.find(lease_id);
        if (it == lease_active_.end()) return false;  // Python-side lease
        if (lease_banned_.count(it->second.worker_id)) {
          // dying worker (Python set its death mark): bounce the whole
          // return to Python, which gives back + kills — never re-pool
          return false;
        }
        for (auto &kv : it->second.resources) {
          if (kv.second > 0) lease_avail_[kv.first] += kv.second;
        }
        lease_idle_.push_back(IdleWorker{
            it->second.worker_id, it->second.job_id, it->second.host,
            it->second.port});
        std::string ev = "{\"ev\":\"return\",\"lease_id\":\"" + lease_id +
                         "\",\"worker_id\":\"" +
                         JsonEscape(it->second.worker_id) + "\"}";
        if (lease_events_.size() < 10000) lease_events_.push_back(ev);
        lease_active_.erase(it);
        ++lease_returns_;
      }
      std::string reply;
      reply.push_back(char(0x81));
      mp::emit_str(reply, "status");
      mp::emit_str(reply, "ok");
      // Wake Python's blocked lease requests: the freed resources were
      // credited entirely in C++, so without this note a contended
      // Python-path lease would sleep out its full wait timeout.
      auto *freed = new Msg();
      freed->conn = m->conn;
      freed->kind = kPush;
      freed->method = "lease_freed";
      *note = freed;
      Send(m->conn, kRep, m->msgid,
           reinterpret_cast<const uint8_t *>(m->method.data()),
           uint32_t(m->method.size()),
           reinterpret_cast<const uint8_t *>(reply.data()),
           uint32_t(reply.size()));
      delete m;
      return true;
    }
    return false;
  }

  std::mutex lease_mu_;
  std::atomic<bool> lease_fast_{false};  // lock-free gate for RouteDecoded
  bool lease_on_ = false;
  std::map<std::string, double> lease_avail_;
  std::deque<IdleWorker> lease_idle_;
  std::unordered_map<std::string, ActiveLease> lease_active_;
  std::deque<std::string> lease_events_;
  std::unordered_set<std::string> lease_banned_;
  uint64_t next_lease_ = 1;
  long long lease_grants_ = 0;
  long long lease_returns_ = 0;

 public:

 private:
  // Engine thread: route freshly parsed frames. Native-call replies and
  // filtered exec requests are consumed here (never touch the Python
  // inbox); everything else lands in `rest` for the inbox.
  void RouteDecoded(std::vector<Msg *> &decoded, std::vector<Msg *> &rest) {
    // Object chunks are absorbed here (engine thread) — Python sees one
    // obj_complete per object, never per-chunk traffic.
    for (auto *&m : decoded) {
      if (m != nullptr && m->kind == kPush && m->method == "obj_chunk") {
        m = HandleObjChunk(m);  // completion note or nullptr
      }
    }
    // Native lease lane: grant/return simple worker leases right here
    // (engine thread) when the agent enabled the table.
    if (lease_fast_.load(std::memory_order_acquire)) {
      for (auto *&m : decoded) {
        if (m != nullptr && m->kind == kReq &&
            (m->method == "lease_worker" ||
             m->method == "return_worker")) {
          Msg *note = nullptr;
          if (TryLeaseFast(m, &note)) {
            m = note;  // lease_freed push (or nullptr) rides to the inbox
          }
        }
      }
    }
    bool exec_on = exec_filter_on_.load(std::memory_order_acquire);
    std::vector<Msg *> to_exec;
    {
      std::lock_guard<std::mutex> lock(call_mu_);
      for (auto *&m : decoded) {
        if (m == nullptr) continue;
        if (m->kind == kRep || m->kind == kErr) {
          auto cit = conn_calls_.find(m->conn);
          if (cit != conn_calls_.end()) {
            auto mit = cit->second.find(m->msgid);
            if (mit != cit->second.end()) {
              auto pit = calls_.find(mit->second);
              if (pit != calls_.end()) {
                pit->second.reply = m;
                pit->second.state = 1;
              } else {
                delete m;  // abandoned call: drop the late reply
              }
              cit->second.erase(mit);
              m = nullptr;
              continue;
            }
          }
        }
      }
    }
    if (exec_on) {
      std::lock_guard<std::mutex> lock(exec_mu_);
      for (auto *&m : decoded) {
        if (m == nullptr) continue;
        if (m->kind == kReq && exec_methods_.count(m->method)) {
          to_exec.push_back(m);
          m = nullptr;
        }
      }
      for (auto *m : to_exec) execq_.push_back(m);
      if (!to_exec.empty()) exec_cv_.notify_one();
    }
    bool any_reply = false;
    for (auto *m : decoded) {
      if (m != nullptr) {
        rest.push_back(m);
      } else {
        any_reply = true;
      }
    }
    if (any_reply) call_cv_.notify_all();
  }

  // Fail every native call pending on a conn (engine thread, conn close).
  void FailCallsForConn(long conn_id) {
    bool any = false;
    {
      std::lock_guard<std::mutex> lock(call_mu_);
      auto cit = conn_calls_.find(conn_id);
      if (cit != conn_calls_.end()) {
        for (auto &kv : cit->second) {
          auto pit = calls_.find(kv.second);
          if (pit != calls_.end()) {
            pit->second.state = 2;
            any = true;
          }
        }
        conn_calls_.erase(cit);
      }
    }
    if (any) call_cv_.notify_all();
  }
  std::shared_ptr<Conn> Lookup(long conn_id) {
    std::lock_guard<std::mutex> lock(mu_);
    auto it = conns_.find(conn_id);
    if (it == conns_.end()) return nullptr;
    return it->second;
  }

  void Wake() {
    uint64_t one = 1;
    ssize_t rc = write(wakefd_, &one, 8);
    (void)rc;
  }

  void NotifyPython() {
    uint64_t one = 1;
    ssize_t rc = write(notifyfd_, &one, 8);
    (void)rc;
  }

  void RequestClose(long conn_id) {
    std::lock_guard<std::mutex> lock(mu_);
    pending_close_.push_back(conn_id);
    Wake();
  }

  long Register(int fd, bool listener) {
    SetNonblock(fd);
    std::lock_guard<std::mutex> lock(mu_);
    long id = next_id_++;
    auto conn = std::make_shared<Conn>();
    conn->id = id;
    conn->fd = fd;
    conn->listener = listener;
    conns_[id] = conn;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = uint64_t(id);
    epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev);
    return id;
  }

  static void SetNonblock(int fd) {
    int flags = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  }

  // wmu must be held (or conn exclusively owned).
  void CloseFd(Conn &c) {
    if (c.fd >= 0) {
      epoll_ctl(epfd_, EPOLL_CTL_DEL, c.fd, nullptr);
      close(c.fd);
      if (c.unix_listener) ::unlink(c.unix_path.c_str());
      c.fd = -1;
    }
    c.closed = true;
  }

  void Loop() {
    epoll_event events[128];
    auto last_sweep = std::chrono::steady_clock::now();
    while (running_) {
      int n = epoll_wait(epfd_, events, 128, 500);
      if (!running_) break;
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      auto now = std::chrono::steady_clock::now();
      if (now - last_sweep > std::chrono::seconds(10)) {
        last_sweep = now;
        SweepStaleTransfers();
      }
      bool notified = false;
      for (int i = 0; i < n; ++i) {
        uint64_t id = events[i].data.u64;
        if (id == 0) {
          uint64_t buf;
          while (read(wakefd_, &buf, 8) > 0) {
          }
          continue;
        }
        HandleEvent(long(id), events[i].events, &notified);
      }
      ProcessDeferred(&notified);
      if (notified) NotifyPython();
    }
  }

  void ProcessDeferred(bool *notified) {
    std::vector<long> to_close, to_arm;
    {
      std::lock_guard<std::mutex> lock(mu_);
      to_close.swap(pending_close_);
      to_arm.swap(pending_arm_);
    }
    for (long id : to_arm) {
      auto conn = Lookup(id);
      if (!conn) continue;
      std::lock_guard<std::mutex> wlock(conn->wmu);
      conn->arm_pending = false;  // senders must re-request from here on
      if (conn->fd >= 0 && !conn->wq.empty()) {
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.u64 = uint64_t(id);
        epoll_ctl(epfd_, EPOLL_CTL_MOD, conn->fd, &ev);
      }
    }
    for (long id : to_close) FinishClose(id, notified);
  }

  void FinishClose(long id, bool *notified) {
    std::shared_ptr<Conn> conn;
    {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = conns_.find(id);
      if (it == conns_.end()) return;
      conn = it->second;
      conns_.erase(it);
      auto *m = new Msg();
      m->conn = id;
      m->kind = kClosed;
      inbox_.push_back(m);
      *notified = true;
    }
    FailCallsForConn(id);
    std::lock_guard<std::mutex> wlock(conn->wmu);
    CloseFd(*conn);
  }

  void HandleEvent(long id, uint32_t evmask, bool *notified) {
    auto conn = Lookup(id);
    if (!conn) return;
    if (conn->listener) {
      if (evmask & EPOLLIN) Accept(id, conn->fd, notified);
      return;
    }
    if (evmask & (EPOLLHUP | EPOLLERR)) {
      RequestClose(id);
      return;
    }
    if (evmask & EPOLLOUT) FlushWrites(*conn);
    if (evmask & EPOLLIN) ReadFrom(*conn, notified);
  }

  void Accept(long listener_id, int lfd, bool *notified) {
    while (true) {
      int cfd = accept4(lfd, nullptr, nullptr, SOCK_CLOEXEC | SOCK_NONBLOCK);
      if (cfd < 0) return;
      int one = 1;
      setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      long id;
      {
        std::lock_guard<std::mutex> lock(mu_);
        id = next_id_++;
        auto conn = std::make_shared<Conn>();
        conn->id = id;
        conn->fd = cfd;
        conns_[id] = conn;
        auto *m = new Msg();
        m->conn = id;
        m->kind = kAccepted;
        m->msgid = uint32_t(listener_id);  // which listener accepted
        inbox_.push_back(m);
        *notified = true;
      }
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.u64 = uint64_t(id);
      epoll_ctl(epfd_, EPOLL_CTL_ADD, cfd, &ev);
    }
  }

  void FlushWrites(Conn &c) {
    std::lock_guard<std::mutex> wlock(c.wmu);
    if (c.closed || c.fd < 0) return;
    // Bound the work done per wmu acquisition: senders (which may hold
    // the GIL for small frames) block on wmu, so a long backlog drain
    // here must not turn into a long stall for them. EPOLLOUT stays
    // armed, the next loop iteration continues the drain.
    size_t budget = 1 << 20;
    while (!c.wq.empty()) {
      // Coalesce queued frames into one writev: a burst of small task
      // frames costs one syscall, not one per frame.
      iovec iov[64];
      int iovcnt = 0;
      size_t bytes = 0;
      size_t off = c.woff;
      for (auto it = c.wq.begin();
           it != c.wq.end() && iovcnt < 64 && bytes < budget; ++it) {
        iov[iovcnt].iov_base = it->data() + off;
        iov[iovcnt].iov_len = it->size() - off;
        bytes += iov[iovcnt].iov_len;
        ++iovcnt;
        off = 0;
      }
      ssize_t n = ::writev(c.fd, iov, iovcnt);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return;
        RequestClose(c.id);
        return;
      }
      size_t left = size_t(n);
      while (left > 0 && !c.wq.empty()) {
        size_t frame_rest = c.wq.front().size() - c.woff;
        if (left >= frame_rest) {
          left -= frame_rest;
          c.wq.pop_front();
          c.woff = 0;
        } else {
          c.woff += left;
          left = 0;
        }
      }
      if (c.woff > 0) return;  // partial frame: wait for EPOLLOUT
      if (size_t(n) >= budget) return;  // keep EPOLLOUT armed, resume next tick
      budget -= size_t(n);
    }
    // Queue drained: stop watching EPOLLOUT.
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = uint64_t(c.id);
    epoll_ctl(epfd_, EPOLL_CTL_MOD, c.fd, &ev);
  }

  void ReadFrom(Conn &c, bool *notified) {
    // Engine thread is the only reader: rbuf needs no lock.
    uint8_t buf[65536];
    std::vector<Msg *> decoded;
    bool dead = false;
    while (true) {
      ssize_t n = read(c.fd, buf, sizeof(buf));
      if (n > 0) {
        c.rbuf.insert(c.rbuf.end(), buf, buf + n);
        if (!ParseFrames(c, decoded)) {
          dead = true;  // malformed stream
          break;
        }
        if (size_t(n) < sizeof(buf)) break;  // likely drained
        continue;
      }
      if (n == 0) {
        dead = true;
        break;
      }
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      dead = true;
      break;
    }
    if (!decoded.empty()) {
      std::vector<Msg *> rest;
      RouteDecoded(decoded, rest);
      if (!rest.empty()) {
        std::lock_guard<std::mutex> lock(mu_);
        for (auto *m : rest) inbox_.push_back(m);
        *notified = true;
      }
    }
    if (dead) RequestClose(c.id);
  }

  // Engine thread only. Returns false on a malformed stream.
  bool ParseFrames(Conn &c, std::vector<Msg *> &out) {
    while (true) {
      size_t avail = c.rbuf.size() - c.rstart;
      if (avail < 4) break;
      const uint8_t *p = c.rbuf.data() + c.rstart;
      uint32_t body;
      memcpy(&body, p, 4);
      if (body < 8 || body > kMaxFrame) return false;
      if (avail < 4 + size_t(body)) break;
      const uint8_t *f = p + 4;
      // f[0]=ver f[1]=kind f[2..5]=msgid f[6..7]=mlen
      uint8_t kind = f[1];
      uint32_t msgid;
      memcpy(&msgid, f + 2, 4);
      uint16_t mlen;
      memcpy(&mlen, f + 6, 2);
      if (size_t(8 + mlen) > body) return false;
      auto *m = new Msg();
      m->conn = c.id;
      m->kind = kind;
      m->msgid = msgid;
      m->method.assign(reinterpret_cast<const char *>(f + 8), mlen);
      m->payload.assign(f + 8 + mlen, f + body);
      out.push_back(m);
      c.rstart += 4 + body;
      frames_recv_.fetch_add(1, std::memory_order_relaxed);
      bytes_recv_.fetch_add(4 + (long long)body, std::memory_order_relaxed);
    }
    // Compact the read buffer once the parsed prefix dominates.
    if (c.rstart > 0 && (c.rstart >= c.rbuf.size() || c.rstart > 1 << 20)) {
      c.rbuf.erase(c.rbuf.begin(), c.rbuf.begin() + c.rstart);
      c.rstart = 0;
    }
    return true;
  }

  int epfd_ = -1;
  int wakefd_ = -1;
  int notifyfd_ = -1;
  std::thread thread_;
  std::atomic<bool> running_{false};
  std::mutex mu_;  // conns_ map, inbox_, pending_* lists
  std::unordered_map<long, std::shared_ptr<Conn>> conns_;
  std::deque<Msg *> inbox_;
  std::vector<long> pending_close_;
  std::vector<long> pending_arm_;
  long next_id_ = 1;

  // Observability counters read by EngineStats: relaxed atomics — the hot
  // paths only add, and the stats reader tolerates momentary skew.
  std::atomic<long long> frames_sent_{0};
  std::atomic<long long> frames_recv_{0};
  std::atomic<long long> bytes_sent_{0};
  std::atomic<long long> bytes_recv_{0};
  std::atomic<long long> chunks_sent_{0};
  std::atomic<long long> chunks_recv_{0};

  // native call table (CallStart/CallWait)
  std::mutex call_mu_;
  std::condition_variable call_cv_;
  std::unordered_map<uint64_t, PendingCall> calls_;
  std::unordered_map<long, std::unordered_map<uint32_t, uint64_t>>
      conn_calls_;
  uint64_t next_call_ = 1;
  int call_waiters_ = 0;  // guarded by call_mu_ (Stop drains to zero)

  // exec fast lane (ExecFilterAdd/ExecNext/ExecInject)
  std::mutex exec_mu_;
  std::condition_variable exec_cv_;
  std::deque<Msg *> execq_;
  std::unordered_set<std::string> exec_methods_;
  std::atomic<bool> exec_filter_on_{false};
  int exec_waiters_ = 0;  // guarded by exec_mu_ (Stop drains to zero)
};

}  // namespace rpc
}  // namespace raytpu

// ---------------------------------------------------------------------------
// C API (ctypes entry points).
// ---------------------------------------------------------------------------
extern "C" {

typedef struct {
  long conn;
  uint8_t kind;
  uint32_t msgid;
  const char *method;
  uint32_t mlen;
  const char *payload;
  uint32_t plen;
  void *opaque;
} rt_msg_view;

void *rt_engine_new() { return new raytpu::rpc::Engine(); }

void rt_engine_stop(void *e) {
  auto *eng = static_cast<raytpu::rpc::Engine *>(e);
  eng->Stop();
  delete eng;
}

int rt_notify_fd(void *e) {
  return static_cast<raytpu::rpc::Engine *>(e)->notify_fd();
}

long rt_connect_tcp(void *e, const char *host, int port) {
  return static_cast<raytpu::rpc::Engine *>(e)->ConnectTcp(host, port);
}

long rt_connect_unix(void *e, const char *path) {
  return static_cast<raytpu::rpc::Engine *>(e)->ConnectUnix(path);
}

long rt_listen_tcp(void *e, const char *host, int port, int *out_port) {
  return static_cast<raytpu::rpc::Engine *>(e)->ListenTcp(host, port, out_port);
}

long rt_listen_unix(void *e, const char *path) {
  return static_cast<raytpu::rpc::Engine *>(e)->ListenUnix(path);
}

uint32_t rt_next_msgid(void *e, long conn) {
  return static_cast<raytpu::rpc::Engine *>(e)->NextMsgid(conn);
}

int rt_send(void *e, long conn, uint8_t kind, uint32_t msgid,
            const uint8_t *method, uint32_t mlen, const uint8_t *payload,
            uint32_t plen) {
  return static_cast<raytpu::rpc::Engine *>(e)->Send(conn, kind, msgid,
                                                     method, mlen, payload,
                                                     plen);
}

void rt_close_conn(void *e, long conn) {
  static_cast<raytpu::rpc::Engine *>(e)->CloseConn(conn);
}

// Debug probe (hang forensics): out[0]=wq_len out[1]=woff out[2]=fd
// out[3]=closed out[4]=bytes_queued out[5]=unparsed_rbuf_bytes.
// Returns 0, or -1 if conn unknown. rbuf fields are read without the
// engine-thread's ownership — debug-only, values may be torn.
int rt_conn_debug(void *e, long conn, long long *out) {
  return static_cast<raytpu::rpc::Engine *>(e)->ConnDebug(conn, out);
}

int rt_list_conns(void *e, long long *out, int cap) {
  return static_cast<raytpu::rpc::Engine *>(e)->ListConns(out, cap);
}

int rt_next(void *e, rt_msg_view *out) {
  auto *m = static_cast<raytpu::rpc::Engine *>(e)->Next();
  if (!m) return 0;
  out->conn = m->conn;
  out->kind = m->kind;
  out->msgid = m->msgid;
  out->method = m->method.data();
  out->mlen = uint32_t(m->method.size());
  out->payload = reinterpret_cast<const char *>(m->payload.data());
  out->plen = uint32_t(m->payload.size());
  out->opaque = m;
  return 1;
}

void rt_msg_free(void *opaque) {
  delete static_cast<raytpu::rpc::Msg *>(opaque);
}

static void fill_view(raytpu::rpc::Msg *m, rt_msg_view *out) {
  out->conn = m->conn;
  out->kind = m->kind;
  out->msgid = m->msgid;
  out->method = m->method.data();
  out->mlen = uint32_t(m->method.size());
  out->payload = reinterpret_cast<const char *>(m->payload.data());
  out->plen = uint32_t(m->payload.size());
  out->opaque = m;
}

// ---------------------------------------------------------------------------
// Native call table: request/reply matching without the asyncio loop.
// ---------------------------------------------------------------------------
uint64_t rt_call_start(void *e, long conn, const uint8_t *method,
                       uint32_t mlen, const uint8_t *payload, uint32_t plen) {
  return static_cast<raytpu::rpc::Engine *>(e)->CallStart(conn, method, mlen,
                                                          payload, plen);
}

// Buffered variant: the frame is queued for the engine thread (coalesced
// writev) instead of an inline send — for bursting submitters.
uint64_t rt_call_start_buf(void *e, long conn, const uint8_t *method,
                           uint32_t mlen, const uint8_t *payload,
                           uint32_t plen) {
  return static_cast<raytpu::rpc::Engine *>(e)->CallStart(
      conn, method, mlen, payload, plen, /*allow_inline=*/false);
}

// Buffered plain send (worker replies while more exec work is queued).
int rt_send_buf(void *e, long conn, uint8_t kind, uint32_t msgid,
                const uint8_t *method, uint32_t mlen, const uint8_t *payload,
                uint32_t plen) {
  return static_cast<raytpu::rpc::Engine *>(e)->Send(
      conn, kind, msgid, method, mlen, payload, plen, /*allow_inline=*/false);
}

int rt_exec_pending(void *e) {
  return static_cast<raytpu::rpc::Engine *>(e)->ExecPending();
}

int rt_conn_inflight(void *e, long conn) {
  return static_cast<raytpu::rpc::Engine *>(e)->ConnInflight(conn);
}

// 1=reply (view filled; free via rt_msg_free), 0=timeout,
// -1=connection lost, -2=unknown handle. Blocks: call via CDLL only.
int rt_call_wait(void *e, uint64_t handle, int timeout_ms, rt_msg_view *out) {
  raytpu::rpc::Msg *m = nullptr;
  int rc = static_cast<raytpu::rpc::Engine *>(e)->CallWait(handle, timeout_ms,
                                                           &m);
  if (rc == 1 && m != nullptr) fill_view(m, out);
  if (rc == -1 && m != nullptr) delete m;
  return rc;
}

// Non-blocking twin of rt_call_wait (PyDLL-safe).
int rt_call_poll(void *e, uint64_t handle, rt_msg_view *out) {
  raytpu::rpc::Msg *m = nullptr;
  int rc = static_cast<raytpu::rpc::Engine *>(e)->CallPoll(handle, &m);
  if (rc == 1 && m != nullptr) fill_view(m, out);
  if (rc == -1 && m != nullptr) delete m;
  return rc;
}

void rt_call_abandon(void *e, uint64_t handle) {
  static_cast<raytpu::rpc::Engine *>(e)->CallAbandon(handle);
}

// ---------------------------------------------------------------------------
// Exec fast lane: divert chosen REQ methods to a dedicated consumer.
// ---------------------------------------------------------------------------
void rt_exec_filter(void *e, const char *method) {
  static_cast<raytpu::rpc::Engine *>(e)->ExecFilterAdd(method);
}

// 1=message (REQ or injected; free via rt_msg_free), 0=timeout,
// -1=engine stopping. Blocks: call via CDLL only.
int rt_exec_next(void *e, int timeout_ms, rt_msg_view *out) {
  raytpu::rpc::Msg *m = nullptr;
  int rc = static_cast<raytpu::rpc::Engine *>(e)->ExecNext(timeout_ms, &m);
  if (rc == 1 && m != nullptr) fill_view(m, out);
  return rc;
}

void rt_exec_inject(void *e, uint32_t tag) {
  static_cast<raytpu::rpc::Engine *>(e)->ExecInject(tag);
}

// ---------------------------------------------------------------------------
// Object-transfer plane: push whole objects as C++-sliced chunk frames.
// ---------------------------------------------------------------------------
int rt_push_object(void *e, long conn, const char *oid, const uint8_t *data,
                   uint64_t len) {
  return static_cast<raytpu::rpc::Engine *>(e)->PushObject(conn, oid, data,
                                                           len);
}

int rt_transfer_take(void *e, const char *oid, const uint8_t **ptr,
                     uint64_t *len) {
  return static_cast<raytpu::rpc::Engine *>(e)->TransferTake(oid, ptr, len);
}

void rt_transfer_free(void *e, const char *oid) {
  static_cast<raytpu::rpc::Engine *>(e)->TransferFree(oid);
}

// ---------------------------------------------------------------------------
// Native lease lane (raylet grant path, N9/N10).
// ---------------------------------------------------------------------------
void rt_lease_enable(void *e, int on) {
  static_cast<raytpu::rpc::Engine *>(e)->LeaseEnable(on);
}

int rt_lease_adjust(void *e, const char *names, const double *deltas, int n,
                    int check) {
  return static_cast<raytpu::rpc::Engine *>(e)->LeaseAdjust(names, deltas, n,
                                                            check);
}

void rt_lease_pool_put(void *e, const char *worker_id, const char *job_id,
                       const char *host, int port) {
  static_cast<raytpu::rpc::Engine *>(e)->LeasePoolPut(worker_id, job_id,
                                                      host, port);
}

int rt_lease_pool_pop(void *e, const char *job_id, char *out, int cap) {
  return static_cast<raytpu::rpc::Engine *>(e)->LeasePoolPop(job_id, out,
                                                             cap);
}

int rt_lease_pool_remove(void *e, const char *worker_id) {
  return static_cast<raytpu::rpc::Engine *>(e)->LeasePoolRemove(worker_id);
}

void rt_lease_worker_ban(void *e, const char *worker_id) {
  static_cast<raytpu::rpc::Engine *>(e)->LeaseWorkerBan(worker_id);
}

void rt_lease_worker_unban(void *e, const char *worker_id) {
  static_cast<raytpu::rpc::Engine *>(e)->LeaseWorkerUnban(worker_id);
}

int rt_lease_forget(void *e, const char *lease_id) {
  return static_cast<raytpu::rpc::Engine *>(e)->LeaseForget(lease_id);
}

int rt_lease_next_event(void *e, char *buf, int cap) {
  return static_cast<raytpu::rpc::Engine *>(e)->LeaseNextEvent(buf, cap);
}

int rt_lease_available_json(void *e, char *buf, int cap) {
  return static_cast<raytpu::rpc::Engine *>(e)->LeaseAvailableJson(buf, cap);
}

void rt_lease_stats(void *e, long long *out) {
  static_cast<raytpu::rpc::Engine *>(e)->LeaseStats(out);
}

void rt_engine_stats(void *e, long long *out) {
  static_cast<raytpu::rpc::Engine *>(e)->EngineStats(out);
}

}  // extern "C"
