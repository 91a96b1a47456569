// TPU-native shared-memory object store (plasma-equivalent).
//
// Role-equivalent of the reference's node-local store + spilling:
//   src/ray/object_manager/plasma/{store.cc,store_runner.cc,client.cc,
//   eviction_policy.cc,create_request_queue.cc} and
//   src/ray/raylet/local_object_manager.cc (spill/restore).
//
// Design (single node):
//   * One mmap'd arena file in /dev/shm shared by all processes on the node.
//   * This server (a thread inside the node agent process) owns allocation,
//     the object table, LRU eviction and spill/restore; clients speak a tiny
//     binary protocol over a unix domain socket and read/write object bytes
//     directly through their own mmap of the arena (zero-copy).
//   * GET blocks server-side until the object is sealed (or timeout), like
//     plasma's get with timeout; eviction only touches sealed objects with
//     refcount zero; under pressure objects spill to a fallback directory
//     and are transparently restored on the next GET.
//
// Protocol: every request is
//   [u32 total_len][u32 reqid][u8 op][payload]
// and every reply is
//   [u32 total_len][u32 reqid][u8 status][payload]
// Ops: 1=CREATE(id,size) 2=SEAL(id) 3=GET(id,timeout_ms) 4=RELEASE(id)
//      5=DELETE(id) 6=CONTAINS(id) 7=LIST 8=STATS 9=PIN(id) 10=UNPIN(id)
// Status: 0=OK 1=NOT_FOUND 2=FULL 3=EXISTS 4=TIMEOUT 5=ERROR

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <ctime>
#include <iterator>
#include <cstdio>
#include <cstring>
#include <deque>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

namespace raytpu {

enum Op : uint8_t {
  OP_CREATE = 1,
  OP_SEAL = 2,
  OP_GET = 3,
  OP_RELEASE = 4,
  OP_DELETE = 5,
  OP_CONTAINS = 6,
  OP_LIST = 7,
  OP_STATS = 8,
  OP_PIN = 9,
  OP_UNPIN = 10,
};

enum Status : uint8_t {
  ST_OK = 0,
  ST_NOT_FOUND = 1,
  ST_FULL = 2,
  ST_EXISTS = 3,
  ST_TIMEOUT = 4,
  ST_ERROR = 5,
};

// ---------------------------------------------------------------------------
// First-fit free-list arena allocator with coalescing.
// ---------------------------------------------------------------------------
class Arena {
 public:
  Arena(uint64_t capacity) : capacity_(capacity) {
    free_list_[0] = capacity;  // offset -> size
  }

  // Returns UINT64_MAX on failure.
  uint64_t Allocate(uint64_t size) {
    if (size == 0) size = 1;
    size = (size + 63) & ~uint64_t(63);  // 64B align
    for (auto it = free_list_.begin(); it != free_list_.end(); ++it) {
      if (it->second >= size) {
        uint64_t off = it->first;
        uint64_t remaining = it->second - size;
        free_list_.erase(it);
        if (remaining > 0) free_list_[off + size] = remaining;
        used_ += size;
        allocated_[off] = size;
        return off;
      }
    }
    return UINT64_MAX;
  }

  void Free(uint64_t offset) {
    auto it = allocated_.find(offset);
    if (it == allocated_.end()) return;
    uint64_t size = it->second;
    allocated_.erase(it);
    used_ -= size;
    // Insert and coalesce with neighbors.
    auto ins = free_list_.emplace(offset, size).first;
    if (ins != free_list_.begin()) {
      auto prev = std::prev(ins);
      if (prev->first + prev->second == ins->first) {
        prev->second += ins->second;
        free_list_.erase(ins);
        ins = prev;
      }
    }
    auto next = std::next(ins);
    if (next != free_list_.end() && ins->first + ins->second == next->first) {
      ins->second += next->second;
      free_list_.erase(next);
    }
  }

  uint64_t used() const { return used_; }
  uint64_t capacity() const { return capacity_; }

 private:
  uint64_t capacity_;
  uint64_t used_ = 0;
  std::map<uint64_t, uint64_t> free_list_;
  std::unordered_map<uint64_t, uint64_t> allocated_;
};

// ---------------------------------------------------------------------------
// Object table.
// ---------------------------------------------------------------------------
struct ObjectEntry {
  uint64_t offset = 0;
  uint64_t size = 0;
  bool sealed = false;
  bool spilled = false;      // bytes live in spill file, not arena
  int64_t refcount = 0;      // client GET refs
  int64_t pins = 0;          // explicit pins (primary copies)
  uint64_t lru_tick = 0;
  int creator_fd = -1;       // connection that created (for abort on dc)
};

struct PendingGet {
  int fd;
  uint32_t reqid;
  int64_t deadline_ms;  // absolute, -1 = infinite
};

static int64_t NowMs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

// ---------------------------------------------------------------------------
// The store server.
// ---------------------------------------------------------------------------
class StoreServer {
 public:
  StoreServer(const std::string &socket_path, const std::string &shm_path,
              uint64_t capacity, const std::string &spill_dir)
      : socket_path_(socket_path),
        shm_path_(shm_path),
        spill_dir_(spill_dir),
        arena_(capacity) {}

  bool Start() {
    shm_fd_ = ::open(shm_path_.c_str(), O_CREAT | O_RDWR, 0600);
    if (shm_fd_ < 0) return false;
    if (ftruncate(shm_fd_, arena_.capacity()) != 0) return false;
    base_ = static_cast<uint8_t *>(mmap(nullptr, arena_.capacity(),
                                        PROT_READ | PROT_WRITE, MAP_SHARED,
                                        shm_fd_, 0));
    if (base_ == MAP_FAILED) return false;

    listen_fd_ = socket(AF_UNIX, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (listen_fd_ < 0) return false;
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    ::unlink(socket_path_.c_str());
    snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", socket_path_.c_str());
    if (bind(listen_fd_, (sockaddr *)&addr, sizeof(addr)) != 0) return false;
    if (listen(listen_fd_, 128) != 0) return false;
    running_ = true;
    thread_ = std::thread([this] { Loop(); });
    // Pre-fault a sliding window of arena pages ahead of the allocation
    // frontier (plasma's warm-memory role): tmpfs pages are zero-filled on
    // first write, so a cold 8 MiB put pays ~2000 page faults + zeroing
    // (~4.5 ms measured) inside the client's copy. Touching pages ahead of
    // use off the critical path keeps client writes at warm-memcpy speed.
    // Window via RAY_TPU_store_prefault_mb (default 256, 0 disables).
    uint64_t window = 256;
    if (const char *env = getenv("RAY_TPU_store_prefault_mb"))
      window = strtoull(env, nullptr, 10);
    prefault_window_ = window << 20;
    if (prefault_window_ > 0)
      prefault_thread_ = std::thread([this] { PrefaultLoop(); });
    return true;
  }

  void Stop() {
    running_ = false;
    // Poke the poll loop.
    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd >= 0) {
      sockaddr_un addr{};
      addr.sun_family = AF_UNIX;
      snprintf(addr.sun_path, sizeof(addr.sun_path), "%s", socket_path_.c_str());
      connect(fd, (sockaddr *)&addr, sizeof(addr));
      close(fd);
    }
    if (thread_.joinable()) thread_.join();
    if (prefault_thread_.joinable()) prefault_thread_.join();
    if (listen_fd_ >= 0) close(listen_fd_);
    ::unlink(socket_path_.c_str());
    if (base_ && base_ != MAP_FAILED) munmap(base_, arena_.capacity());
    if (shm_fd_ >= 0) close(shm_fd_);
    ::unlink(shm_path_.c_str());
  }

 private:
  struct Conn {
    std::vector<uint8_t> inbuf;
    std::deque<std::vector<uint8_t>> outq;
    size_t out_off = 0;
  };

  void Loop() {
    while (running_) {
      std::vector<pollfd> fds;
      fds.push_back({listen_fd_, POLLIN, 0});
      for (auto &kv : conns_) {
        short events = POLLIN;
        if (!kv.second.outq.empty()) events |= POLLOUT;
        fds.push_back({kv.first, events, 0});
      }
      int timeout = pending_gets_.empty() ? 200 : 20;
      int n = poll(fds.data(), fds.size(), timeout);
      if (!running_) break;
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      if (fds[0].revents & POLLIN) {
        int cfd = accept4(listen_fd_, nullptr, nullptr, SOCK_CLOEXEC);
        if (cfd >= 0) conns_[cfd];  // default-construct
      }
      std::vector<int> dead;
      for (size_t i = 1; i < fds.size(); ++i) {
        int fd = fds[i].fd;
        auto it = conns_.find(fd);
        if (it == conns_.end()) continue;
        if (fds[i].revents & (POLLHUP | POLLERR)) {
          dead.push_back(fd);
          continue;
        }
        if (fds[i].revents & POLLIN) {
          if (!ReadFrom(fd, it->second)) dead.push_back(fd);
        }
        if (fds[i].revents & POLLOUT) {
          if (!FlushTo(fd, it->second)) dead.push_back(fd);
        }
      }
      for (int fd : dead) DropConn(fd);
      ExpirePendingGets();
    }
  }

  bool ReadFrom(int fd, Conn &conn) {
    uint8_t buf[65536];
    while (true) {
      ssize_t n = recv(fd, buf, sizeof(buf), MSG_DONTWAIT);
      if (n > 0) {
        conn.inbuf.insert(conn.inbuf.end(), buf, buf + n);
      } else if (n == 0) {
        return false;
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        return false;
      }
    }
    // Parse complete frames.
    size_t pos = 0;
    while (conn.inbuf.size() - pos >= 4) {
      uint32_t len;
      memcpy(&len, conn.inbuf.data() + pos, 4);
      if (conn.inbuf.size() - pos - 4 < len) break;
      HandleRequest(fd, conn.inbuf.data() + pos + 4, len);
      pos += 4 + len;
    }
    if (pos > 0) conn.inbuf.erase(conn.inbuf.begin(), conn.inbuf.begin() + pos);
    return true;
  }

  bool FlushTo(int fd, Conn &conn) {
    while (!conn.outq.empty()) {
      auto &front = conn.outq.front();
      ssize_t n = send(fd, front.data() + conn.out_off,
                       front.size() - conn.out_off, MSG_DONTWAIT | MSG_NOSIGNAL);
      if (n > 0) {
        conn.out_off += n;
        if (conn.out_off == front.size()) {
          conn.outq.pop_front();
          conn.out_off = 0;
        }
      } else {
        if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
        return false;
      }
    }
    return true;
  }

  void Reply(int fd, uint32_t reqid, uint8_t status,
             const std::vector<uint8_t> &payload = {}) {
    auto it = conns_.find(fd);
    if (it == conns_.end()) return;
    std::vector<uint8_t> frame(4 + 4 + 1 + payload.size());
    uint32_t len = 4 + 1 + payload.size();
    memcpy(frame.data(), &len, 4);
    memcpy(frame.data() + 4, &reqid, 4);
    frame[8] = status;
    if (!payload.empty()) memcpy(frame.data() + 9, payload.data(), payload.size());
    it->second.outq.push_back(std::move(frame));
    FlushTo(fd, it->second);
  }

  static void PutU64(std::vector<uint8_t> &v, uint64_t x) {
    size_t off = v.size();
    v.resize(off + 8);
    memcpy(v.data() + off, &x, 8);
  }

  void HandleRequest(int fd, const uint8_t *data, uint32_t len) {
    last_activity_ms_.store(NowMs(), std::memory_order_relaxed);
    if (len < 5) return;
    uint32_t reqid;
    memcpy(&reqid, data, 4);
    uint8_t op = data[4];
    const uint8_t *p = data + 5;
    uint32_t remaining = len - 5;

    auto read_id = [&]() -> std::string {
      if (remaining < 2) return "";
      uint16_t idlen;
      memcpy(&idlen, p, 2);
      if (remaining < uint32_t(2 + idlen)) return "";
      std::string id(reinterpret_cast<const char *>(p + 2), idlen);
      p += 2 + idlen;
      remaining -= 2 + idlen;
      return id;
    };

    switch (op) {
      case OP_CREATE: {
        std::string id = read_id();
        if (id.empty() || remaining < 8) return Reply(fd, reqid, ST_ERROR);
        uint64_t size;
        memcpy(&size, p, 8);
        if (objects_.count(id)) return Reply(fd, reqid, ST_EXISTS);
        uint64_t off;
        {
          // The prefault thread zeroes pages strictly above high_water_;
          // allocation and the watermark bump must be atomic w.r.t. it.
          std::lock_guard<std::mutex> lock(prefault_mu_);
          off = AllocateWithEviction(size);
          if (off != UINT64_MAX && off + size > high_water_)
            high_water_ = off + size;
        }
        if (off == UINT64_MAX) return Reply(fd, reqid, ST_FULL);
        ObjectEntry e;
        e.offset = off;
        e.size = size;
        e.creator_fd = fd;
        e.lru_tick = ++lru_clock_;
        objects_[id] = e;
        std::vector<uint8_t> payload;
        PutU64(payload, off);
        // Tell the client whether the pages are already committed: it
        // read-touches warm regions (fast PTE populate before its copy)
        // but must NOT touch cold ones — read-faulting a tmpfs hole maps
        // the shared zero page and makes the later write-fault pricier
        // than a plain cold write.
        payload.push_back(
            off + size <= prefault_done_.load(std::memory_order_relaxed) ? 1
                                                                         : 0);
        Reply(fd, reqid, ST_OK, payload);
        break;
      }
      case OP_SEAL: {
        std::string id = read_id();
        auto it = objects_.find(id);
        if (it == objects_.end()) return Reply(fd, reqid, ST_NOT_FOUND);
        it->second.sealed = true;
        it->second.creator_fd = -1;
        Reply(fd, reqid, ST_OK);
        // Wake pending gets.
        auto pit = pending_gets_.find(id);
        if (pit != pending_gets_.end()) {
          for (auto &pg : pit->second) ReplyGet(pg.fd, pg.reqid, id);
          pending_gets_.erase(pit);
        }
        break;
      }
      case OP_GET: {
        std::string id = read_id();
        if (remaining < 8) return Reply(fd, reqid, ST_ERROR);
        int64_t timeout_ms;
        memcpy(&timeout_ms, p, 8);
        auto it = objects_.find(id);
        if (it != objects_.end() && it->second.sealed) {
          if (it->second.spilled && !Restore(id, it->second)) {
            return Reply(fd, reqid, ST_ERROR);
          }
          ReplyGet(fd, reqid, id);
        } else if (timeout_ms == 0) {
          Reply(fd, reqid, ST_NOT_FOUND);
        } else {
          int64_t deadline = timeout_ms < 0 ? -1 : NowMs() + timeout_ms;
          pending_gets_[id].push_back({fd, reqid, deadline});
        }
        break;
      }
      case OP_RELEASE: {
        std::string id = read_id();
        auto it = objects_.find(id);
        if (it != objects_.end() && it->second.refcount > 0) {
          it->second.refcount--;
        }
        Reply(fd, reqid, ST_OK);
        break;
      }
      case OP_DELETE: {
        std::string id = read_id();
        auto it = objects_.find(id);
        if (it == objects_.end()) return Reply(fd, reqid, ST_NOT_FOUND);
        DeleteEntry(it);
        Reply(fd, reqid, ST_OK);
        break;
      }
      case OP_CONTAINS: {
        std::string id = read_id();
        auto it = objects_.find(id);
        bool have = it != objects_.end() && it->second.sealed;
        Reply(fd, reqid, have ? ST_OK : ST_NOT_FOUND);
        break;
      }
      case OP_LIST: {
        std::vector<uint8_t> payload;
        PutU64(payload, objects_.size());
        for (auto &kv : objects_) {
          uint16_t idlen = kv.first.size();
          size_t off = payload.size();
          payload.resize(off + 2 + idlen);
          memcpy(payload.data() + off, &idlen, 2);
          memcpy(payload.data() + off + 2, kv.first.data(), idlen);
          PutU64(payload, kv.second.size);
          PutU64(payload, (kv.second.sealed ? 1 : 0) |
                              (kv.second.spilled ? 2 : 0));
          PutU64(payload, uint64_t(kv.second.refcount));
        }
        Reply(fd, reqid, ST_OK, payload);
        break;
      }
      case OP_STATS: {
        std::vector<uint8_t> payload;
        PutU64(payload, arena_.capacity());
        PutU64(payload, arena_.used());
        PutU64(payload, objects_.size());
        PutU64(payload, spilled_bytes_);
        PutU64(payload, evictions_);
        PutU64(payload, restores_);
        Reply(fd, reqid, ST_OK, payload);
        break;
      }
      case OP_PIN:
      case OP_UNPIN: {
        std::string id = read_id();
        auto it = objects_.find(id);
        if (it == objects_.end()) return Reply(fd, reqid, ST_NOT_FOUND);
        it->second.pins += (op == OP_PIN) ? 1 : -1;
        if (it->second.pins < 0) it->second.pins = 0;
        Reply(fd, reqid, ST_OK);
        break;
      }
      default:
        Reply(fd, reqid, ST_ERROR);
    }
  }

  void ReplyGet(int fd, uint32_t reqid, const std::string &id) {
    auto it = objects_.find(id);
    if (it == objects_.end()) return Reply(fd, reqid, ST_NOT_FOUND);
    it->second.refcount++;
    it->second.lru_tick = ++lru_clock_;
    std::vector<uint8_t> payload;
    PutU64(payload, it->second.offset);
    PutU64(payload, it->second.size);
    Reply(fd, reqid, ST_OK, payload);
  }

  void ExpirePendingGets() {
    int64_t now = NowMs();
    for (auto it = pending_gets_.begin(); it != pending_gets_.end();) {
      auto &vec = it->second;
      for (auto pit = vec.begin(); pit != vec.end();) {
        if (pit->deadline >= 0 && pit->deadline <= now) {
          Reply(pit->fd, pit->reqid, ST_TIMEOUT);
          pit = vec.erase(pit);
        } else {
          ++pit;
        }
      }
      it = vec.empty() ? pending_gets_.erase(it) : std::next(it);
    }
  }

  struct PendingGetEntry {
    int fd;
    uint32_t reqid;
    int64_t deadline;
  };

  uint64_t AllocateWithEviction(uint64_t size) {
    uint64_t off = arena_.Allocate(size);
    while (off == UINT64_MAX) {
      if (!EvictOne()) return UINT64_MAX;
      off = arena_.Allocate(size);
    }
    return off;
  }

  // Evict the least-recently-used sealed, unreferenced, unpinned object.
  // Spills it first when a spill directory is configured
  // (local_object_manager.cc-equivalent behavior).
  bool EvictOne() {
    std::string victim;
    uint64_t best_tick = UINT64_MAX;
    for (auto &kv : objects_) {
      auto &e = kv.second;
      if (e.sealed && !e.spilled && e.refcount == 0 && e.pins == 0 &&
          e.lru_tick < best_tick) {
        best_tick = e.lru_tick;
        victim = kv.first;
      }
    }
    if (victim.empty()) return false;
    auto &e = objects_[victim];
    if (!spill_dir_.empty()) {
      if (Spill(victim, e)) {
        arena_.Free(e.offset);
        e.spilled = true;
        evictions_++;
        return true;
      }
    }
    arena_.Free(e.offset);
    objects_.erase(victim);
    evictions_++;
    return true;
  }

  std::string SpillPath(const std::string &id) {
    std::string safe = id;
    for (auto &c : safe)
      if (c == '/') c = '_';
    return spill_dir_ + "/" + safe + ".spill";
  }

  bool Spill(const std::string &id, ObjectEntry &e) {
    mkdir(spill_dir_.c_str(), 0700);
    std::string path = SpillPath(id);
    int fd = ::open(path.c_str(), O_CREAT | O_WRONLY | O_TRUNC, 0600);
    if (fd < 0) return false;
    const uint8_t *src = base_ + e.offset;
    uint64_t written = 0;
    while (written < e.size) {
      ssize_t n = write(fd, src + written, e.size - written);
      if (n <= 0) {
        close(fd);
        return false;
      }
      written += n;
    }
    close(fd);
    spilled_bytes_ += e.size;
    return true;
  }

  bool Restore(const std::string &id, ObjectEntry &e) {
    uint64_t off = AllocateWithEviction(e.size);
    if (off == UINT64_MAX) return false;
    std::string path = SpillPath(id);
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) {
      arena_.Free(off);
      return false;
    }
    uint8_t *dst = base_ + off;
    uint64_t got = 0;
    while (got < e.size) {
      ssize_t n = read(fd, dst + got, e.size - got);
      if (n <= 0) break;
      got += n;
    }
    close(fd);
    if (got != e.size) {
      arena_.Free(off);
      return false;
    }
    ::unlink(path.c_str());
    e.offset = off;
    e.spilled = false;
    spilled_bytes_ -= e.size;
    restores_++;
    return true;
  }

  void DeleteEntry(std::unordered_map<std::string, ObjectEntry>::iterator it) {
    if (it->second.spilled) {
      ::unlink(SpillPath(it->first).c_str());
      spilled_bytes_ -= it->second.size;
    } else {
      arena_.Free(it->second.offset);
    }
    objects_.erase(it);
  }

  void DropConn(int fd) {
    // Abort unsealed creations from this connection (client died mid-write).
    for (auto it = objects_.begin(); it != objects_.end();) {
      if (!it->second.sealed && it->second.creator_fd == fd) {
        arena_.Free(it->second.offset);
        it = objects_.erase(it);
      } else {
        ++it;
      }
    }
    for (auto &kv : pending_gets_) {
      auto &vec = kv.second;
      vec.erase(std::remove_if(vec.begin(), vec.end(),
                               [fd](const PendingGetEntry &pg) {
                                 return pg.fd == fd;
                               }),
                vec.end());
    }
    close(fd);
    conns_.erase(fd);
  }

  std::string socket_path_;
  std::string shm_path_;
  std::string spill_dir_;
  Arena arena_;
  uint8_t *base_ = nullptr;
  int shm_fd_ = -1;
  int listen_fd_ = -1;
  // Written by Stop() (any thread), read by the poll + prefault loops.
  std::atomic<bool> running_{false};
  std::thread thread_;
  std::unordered_map<int, Conn> conns_;
  std::unordered_map<std::string, ObjectEntry> objects_;
  std::unordered_map<std::string, std::vector<PendingGetEntry>> pending_gets_;
  uint64_t lru_clock_ = 0;
  uint64_t spilled_bytes_ = 0;
  uint64_t evictions_ = 0;
  uint64_t restores_ = 0;

  // --- page prefault (warm-memory window) ---
  std::mutex prefault_mu_;
  uint64_t high_water_ = 0;        // guarded by prefault_mu_
  uint64_t prefault_window_ = 0;   // bytes ahead of high_water_ to keep warm
  std::thread prefault_thread_;
  std::atomic<int64_t> last_activity_ms_{0};
  std::atomic<uint64_t> prefault_done_{0};

  void PrefaultLoop() {
    constexpr uint64_t kPage = 4096;
    constexpr uint64_t kChunk = 1 << 20;  // bound per-lock stall to ~0.5 ms
    uint64_t done = 0;  // everything below this is committed
    while (running_) {
      // Back off while the store is actively serving: on few-core hosts
      // the zeroing competes with client copies for the same CPU, turning
      // the warm-window optimization into a sustained-path regression.
      // Commit pages only in idle gaps.
      // 200 ms: longer than any single client copy, so "no requests for
      // 200 ms" reliably means the node is idle rather than a client being
      // mid-copy between its create and seal.
      if (NowMs() - last_activity_ms_.load(std::memory_order_relaxed) < 200) {
        usleep(20000);
        continue;
      }
      uint64_t target, start;
      {
        std::lock_guard<std::mutex> lock(prefault_mu_);
        target = std::min(arena_.capacity(), high_water_ + prefault_window_);
        // Pages below high_water_ belong to live/former allocations —
        // clients commit those with their own writes; never touch them.
        start = std::max(done, high_water_);
        if (start < target) {
          uint64_t end = std::min(target, start + kChunk);
          for (uint64_t off = start; off < end; off += kPage)
            const_cast<volatile uint8_t *>(base_)[off] = 0;
          done = end;
          prefault_done_.store(done, std::memory_order_relaxed);
        }
      }
      if (done >= target) usleep(20000);
    }
  }
};

}  // namespace raytpu

// ---------------------------------------------------------------------------
// C API (ctypes entry points).
// ---------------------------------------------------------------------------
extern "C" {

void *raytpu_store_start(const char *socket_path, const char *shm_path,
                         uint64_t capacity, const char *spill_dir) {
  auto *server = new raytpu::StoreServer(socket_path, shm_path, capacity,
                                         spill_dir ? spill_dir : "");
  if (!server->Start()) {
    delete server;
    return nullptr;
  }
  return server;
}

void raytpu_store_stop(void *handle) {
  auto *server = static_cast<raytpu::StoreServer *>(handle);
  server->Stop();
  delete server;
}

}  // extern "C"
