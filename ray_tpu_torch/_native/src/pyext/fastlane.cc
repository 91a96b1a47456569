// _fastlane — CPython extension for the per-task hot path (N18–N20).
//
// Role-equivalent of the reference's worker-side task receiver plumbing
// (src/ray/core_worker/transport/task_receiver.cc ::
// actor_scheduling_queue.cc) and the submit/reply envelope handling in
// _raylet.pyx: everything between the socket and the user function —
// frame decode, eligibility classification, reply encode, request/reply
// matching — runs in C++; Python sees one C call per task on each side
// and keeps ONLY pickle + user-function invocation.
//
// The module does not link against libraytpu.so at build time: attach()
// dlopens the already-loaded engine library and resolves the rt_*
// entry points, so the ctypes loader stays the single build owner.
//
// Payload codecs are hand-specialized scanners over the SAME canonical
// msgpack maps as the generated codecs (src/schema/wire_schema.py ::
// TaskSpec / ActorTaskSpec / TaskReply). They read fields BY KEY, skip
// unknown keys, and default missing ones — the N14 version-skew rules —
// and tests/test_wire_schema.py asserts byte/field parity against the
// generated Python codecs. Anything the scanner cannot prove simple is
// bounced back to Python's full decoder, so correctness never depends
// on this file keeping up with rare fields.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <string>

namespace {

// ---------------------------------------------------------------------------
// Engine ABI (mirrors src/rpc/transport.cc extern "C" surface)
// ---------------------------------------------------------------------------
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

typedef int (*fn_exec_next)(void *, int, rt_msg_view *);
typedef void (*fn_msg_free)(void *);
typedef int (*fn_send)(void *, long, uint8_t, uint32_t, const uint8_t *,
                       uint32_t, const uint8_t *, uint32_t);
typedef int (*fn_exec_pending)(void *);
typedef uint64_t (*fn_call_start)(void *, long, const uint8_t *, uint32_t,
                                  const uint8_t *, uint32_t);
typedef int (*fn_call_wait)(void *, uint64_t, int, rt_msg_view *);

static fn_exec_next p_exec_next = nullptr;
static fn_msg_free p_msg_free = nullptr;
static fn_send p_send = nullptr;
static fn_send p_send_buf = nullptr;
static fn_exec_pending p_exec_pending = nullptr;
static fn_call_start p_call_start = nullptr;
static fn_call_start p_call_start_buf = nullptr;
static fn_call_wait p_call_wait = nullptr;

constexpr uint8_t kRep = 1;
constexpr uint8_t kErr = 2;
constexpr uint8_t kInjected = 253;

// ---------------------------------------------------------------------------
// msgpack scanning (decode side)
// ---------------------------------------------------------------------------
struct Cursor {
  const uint8_t *p;
  const uint8_t *end;
  bool ok = true;

  uint8_t peek() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p;
  }
  uint8_t take() {
    if (p >= end) {
      ok = false;
      return 0;
    }
    return *p++;
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

// Reads a map header; returns count or sets !ok.
static uint32_t read_map_header(Cursor &c) {
  uint8_t b = c.take();
  if (!c.ok) return 0;
  if ((b & 0xF0) == 0x80) return b & 0x0F;
  if (b == 0xDE) return uint32_t(c.be(2));
  if (b == 0xDF) return uint32_t(c.be(4));
  c.ok = false;
  return 0;
}

// Reads a str; returns (ptr, len) via out params.
static bool read_str(Cursor &c, const char **s, uint32_t *n) {
  uint8_t b = c.take();
  if (!c.ok) return false;
  uint32_t len;
  if ((b & 0xE0) == 0xA0) {
    len = b & 0x1F;
  } else if (b == 0xD9) {
    len = uint32_t(c.be(1));
  } else if (b == 0xDA) {
    len = uint32_t(c.be(2));
  } else if (b == 0xDB) {
    len = uint32_t(c.be(4));
  } else {
    c.ok = false;
    return false;
  }
  if (!c.need(len)) return false;
  *s = reinterpret_cast<const char *>(c.p);
  *n = len;
  c.p += len;
  return true;
}

static bool read_bin(Cursor &c, const char **s, uint32_t *n) {
  uint8_t b = c.take();
  if (!c.ok) return false;
  uint32_t len;
  if (b == 0xC4) {
    len = uint32_t(c.be(1));
  } else if (b == 0xC5) {
    len = uint32_t(c.be(2));
  } else if (b == 0xC6) {
    len = uint32_t(c.be(4));
  } else if ((b & 0xE0) == 0xA0 || b == 0xD9 || b == 0xDA || b == 0xDB) {
    // tolerate str-typed payloads (a generic peer may pack bytes as str8)
    c.p--;
    return read_str(c, s, n);
  } else {
    c.ok = false;
    return false;
  }
  if (!c.need(len)) return false;
  *s = reinterpret_cast<const char *>(c.p);
  *n = len;
  c.p += len;
  return true;
}

static bool read_uint(Cursor &c, uint64_t *out) {
  uint8_t b = c.take();
  if (!c.ok) return false;
  if (b < 0x80) {
    *out = b;
    return true;
  }
  if (b == 0xCC) {
    *out = c.be(1);
    return c.ok;
  }
  if (b == 0xCD) {
    *out = c.be(2);
    return c.ok;
  }
  if (b == 0xCE) {
    *out = c.be(4);
    return c.ok;
  }
  if (b == 0xCF) {
    *out = c.be(8);
    return c.ok;
  }
  c.ok = false;
  return false;
}

// Skip one msgpack value of any type (bounded recursion for containers).
static bool skip_value(Cursor &c, int depth = 0) {
  if (depth > 32) {
    c.ok = false;
    return false;
  }
  uint8_t b = c.take();
  if (!c.ok) return false;
  if (b < 0x80 || b >= 0xE0) return true;              // fixint
  if ((b & 0xF0) == 0x80) {                            // fixmap
    uint32_t n = b & 0x0F;
    for (uint32_t i = 0; i < 2 * n; ++i)
      if (!skip_value(c, depth + 1)) return false;
    return true;
  }
  if ((b & 0xF0) == 0x90) {                            // fixarray
    uint32_t n = b & 0x0F;
    for (uint32_t i = 0; i < n; ++i)
      if (!skip_value(c, depth + 1)) return false;
    return true;
  }
  if ((b & 0xE0) == 0xA0) {                            // fixstr
    uint32_t n = b & 0x1F;
    if (!c.need(n)) return false;
    c.p += n;
    return true;
  }
  switch (b) {
    case 0xC0:  // nil
    case 0xC2:  // false
    case 0xC3:  // true
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
    case 0xCA:
      return c.need(4) && (c.p += 4, true);
    case 0xCB:
      return c.need(8) && (c.p += 8, true);
    case 0xCC:
    case 0xD0:
      return c.need(1) && (c.p += 1, true);
    case 0xCD:
    case 0xD1:
      return c.need(2) && (c.p += 2, true);
    case 0xCE:
    case 0xD2:
      return c.need(4) && (c.p += 4, true);
    case 0xCF:
    case 0xD3:
      return c.need(8) && (c.p += 8, true);
    case 0xDC: {
      uint64_t n = c.be(2);
      for (uint64_t i = 0; i < n; ++i)
        if (!skip_value(c, depth + 1)) return false;
      return true;
    }
    case 0xDD: {
      uint64_t n = c.be(4);
      for (uint64_t i = 0; i < n; ++i)
        if (!skip_value(c, depth + 1)) return false;
      return true;
    }
    case 0xDE: {
      uint64_t n = c.be(2);
      for (uint64_t i = 0; i < 2 * n; ++i)
        if (!skip_value(c, depth + 1)) return false;
      return true;
    }
    case 0xDF: {
      uint64_t n = c.be(4);
      for (uint64_t i = 0; i < 2 * n; ++i)
        if (!skip_value(c, depth + 1)) return false;
      return true;
    }
    default:
      c.ok = false;  // ext types etc. — not used by the wire schema
      return false;
  }
}

struct Span {
  const char *p = nullptr;
  uint32_t n = 0;
  bool seen = false;
};

static bool key_is(const char *k, uint32_t n, const char *lit) {
  size_t ln = strlen(lit);
  return n == ln && memcmp(k, lit, ln) == 0;
}

// Decoded push_task fields the fast path needs; everything else skipped.
struct TaskScan {
  Span task_id, function_id, name, args;
  uint64_t num_returns = 1;
  bool has_ref_args = false;
  bool cross_language = false;
  bool trace_present = false;  // trace_ctx non-nil → bounce (spans must live)
  bool parse_ok = false;
};

static void scan_task_spec(const uint8_t *data, size_t len, TaskScan *out) {
  Cursor c{data, data + len};
  uint32_t n = read_map_header(c);
  if (!c.ok) return;
  for (uint32_t i = 0; i < n && c.ok; ++i) {
    const char *k;
    uint32_t kn;
    if (!read_str(c, &k, &kn)) return;
    if (key_is(k, kn, "task_id")) {
      if (!read_str(c, &out->task_id.p, &out->task_id.n)) return;
      out->task_id.seen = true;
    } else if (key_is(k, kn, "function_id")) {
      if (!read_str(c, &out->function_id.p, &out->function_id.n)) return;
      out->function_id.seen = true;
    } else if (key_is(k, kn, "name")) {
      if (!read_str(c, &out->name.p, &out->name.n)) return;
      out->name.seen = true;
    } else if (key_is(k, kn, "args")) {
      if (!read_bin(c, &out->args.p, &out->args.n)) return;
      out->args.seen = true;
    } else if (key_is(k, kn, "num_returns")) {
      if (!read_uint(c, &out->num_returns)) return;
    } else if (key_is(k, kn, "has_ref_args")) {
      uint8_t b = c.take();
      if (!c.ok) return;
      out->has_ref_args = (b == 0xC3);
      if (b != 0xC2 && b != 0xC3) return;
    } else if (key_is(k, kn, "cross_language")) {
      uint8_t b = c.take();
      if (!c.ok) return;
      out->cross_language = (b == 0xC3);
      if (b != 0xC2 && b != 0xC3) return;
    } else if (key_is(k, kn, "trace_ctx")) {
      if (c.peek() == 0xC0) {
        c.take();
      } else {
        out->trace_present = true;
        if (!skip_value(c)) return;
      }
    } else {
      if (!skip_value(c)) return;
    }
  }
  out->parse_ok = c.ok && out->task_id.seen && out->function_id.seen &&
                  out->args.seen;
}

struct ActorScan {
  Span task_id, method, name, caller_id, args;
  uint64_t num_returns = 1;
  uint64_t seq = 0;
  bool has_ref_args = false;
  bool trace_present = false;
  bool parse_ok = false;
};

static void scan_actor_spec(const uint8_t *data, size_t len, ActorScan *out) {
  Cursor c{data, data + len};
  uint32_t n = read_map_header(c);
  if (!c.ok) return;
  for (uint32_t i = 0; i < n && c.ok; ++i) {
    const char *k;
    uint32_t kn;
    if (!read_str(c, &k, &kn)) return;
    if (key_is(k, kn, "seq")) {
      if (!read_uint(c, &out->seq)) return;
    } else if (key_is(k, kn, "task_id")) {
      if (!read_str(c, &out->task_id.p, &out->task_id.n)) return;
      out->task_id.seen = true;
    } else if (key_is(k, kn, "method")) {
      if (!read_str(c, &out->method.p, &out->method.n)) return;
      out->method.seen = true;
    } else if (key_is(k, kn, "name")) {
      if (!read_str(c, &out->name.p, &out->name.n)) return;
      out->name.seen = true;
    } else if (key_is(k, kn, "caller_id")) {
      if (!read_str(c, &out->caller_id.p, &out->caller_id.n)) return;
      out->caller_id.seen = true;
    } else if (key_is(k, kn, "args")) {
      if (!read_bin(c, &out->args.p, &out->args.n)) return;
      out->args.seen = true;
    } else if (key_is(k, kn, "num_returns")) {
      if (!read_uint(c, &out->num_returns)) return;
    } else if (key_is(k, kn, "has_ref_args")) {
      uint8_t b = c.take();
      if (!c.ok) return;
      out->has_ref_args = (b == 0xC3);
      if (b != 0xC2 && b != 0xC3) return;
    } else if (key_is(k, kn, "trace_ctx")) {
      if (c.peek() == 0xC0) {
        c.take();
      } else {
        out->trace_present = true;
        if (!skip_value(c)) return;
      }
    } else {
      if (!skip_value(c)) return;
    }
  }
  out->parse_ok = c.ok && out->task_id.seen && out->method.seen &&
                  out->caller_id.seen && out->args.seen;
}

// TaskReply scan (driver settle side): ok + exactly one inline return.
struct ReplyScan {
  bool simple = false;  // status=="ok" && 1 inline return
  Span data;
};

static void scan_task_reply(const uint8_t *data, size_t len, ReplyScan *out) {
  Cursor c{data, data + len};
  uint32_t n = read_map_header(c);
  if (!c.ok) return;
  bool status_ok = false;
  bool one_inline = false;
  for (uint32_t i = 0; i < n && c.ok; ++i) {
    const char *k;
    uint32_t kn;
    if (!read_str(c, &k, &kn)) return;
    if (key_is(k, kn, "status")) {
      const char *s;
      uint32_t sn;
      if (!read_str(c, &s, &sn)) return;
      status_ok = (sn == 2 && memcmp(s, "ok", 2) == 0);
      if (!status_ok) return;  // error/cancelled → full Python decode
    } else if (key_is(k, kn, "returns")) {
      uint8_t b = c.take();
      if (!c.ok) return;
      uint32_t rn;
      if ((b & 0xF0) == 0x90) {
        rn = b & 0x0F;
      } else if (b == 0xDC) {
        rn = uint32_t(c.be(2));
      } else if (b == 0xDD) {
        rn = uint32_t(c.be(4));
      } else {
        c.ok = false;
        return;
      }
      if (rn != 1) return;  // multi-return → Python
      uint32_t fields = read_map_header(c);
      if (!c.ok) return;
      bool kind_inline = false;
      bool have_data = false;
      for (uint32_t f = 0; f < fields && c.ok; ++f) {
        const char *fk;
        uint32_t fkn;
        if (!read_str(c, &fk, &fkn)) return;
        if (key_is(fk, fkn, "kind")) {
          const char *kv;
          uint32_t kvn;
          if (!read_str(c, &kv, &kvn)) return;
          kind_inline = (kvn == 6 && memcmp(kv, "inline", 6) == 0);
          if (!kind_inline) return;  // shm/msgpack → Python
        } else if (key_is(fk, fkn, "data")) {
          if (!read_bin(c, &out->data.p, &out->data.n)) return;
          have_data = true;
        } else {
          if (!skip_value(c)) return;
        }
      }
      one_inline = kind_inline && have_data;
    } else {
      if (!skip_value(c)) return;
    }
  }
  out->simple = c.ok && status_ok && one_inline;
}

// ---------------------------------------------------------------------------
// msgpack emission (encode side) — matches msgpack-python use_bin_type=True
// ---------------------------------------------------------------------------
static void emit_str_header(std::string &out, size_t n) {
  if (n < 32) {
    out.push_back(char(0xA0 | n));
  } else if (n < 256) {
    out.push_back(char(0xD9));
    out.push_back(char(n));
  } else if (n < 65536) {
    out.push_back(char(0xDA));
    out.push_back(char(n >> 8));
    out.push_back(char(n));
  } else {
    out.push_back(char(0xDB));
    out.push_back(char(n >> 24));
    out.push_back(char(n >> 16));
    out.push_back(char(n >> 8));
    out.push_back(char(n));
  }
}

static void emit_bin_header(std::string &out, size_t n) {
  if (n < 256) {
    out.push_back(char(0xC4));
    out.push_back(char(n));
  } else if (n < 65536) {
    out.push_back(char(0xC5));
    out.push_back(char(n >> 8));
    out.push_back(char(n));
  } else {
    out.push_back(char(0xC6));
    out.push_back(char(n >> 24));
    out.push_back(char(n >> 16));
    out.push_back(char(n >> 8));
    out.push_back(char(n));
  }
}

static void emit_key(std::string &out, const char *k) {
  size_t n = strlen(k);
  out.push_back(char(0xA0 | n));  // schema keys are < 32 chars
  out.append(k, n);
}

// Canonical TaskReply{status:"ok", returns:[{kind:"inline", data}],
// error:b"", error_text:""} — byte-identical to wire_gen.encode_task_reply
// on the dict the worker's Python path builds (nested ReturnValue dicts
// pack their own two keys; decoders default size/location).
static void build_ok_inline_reply(std::string &out, const char *data,
                                  size_t dlen) {
  out.reserve(48 + dlen);
  out.push_back(char(0x84));  // map 4
  emit_key(out, "status");
  emit_key(out, "ok");  // "ok" encodes as fixstr, same as a key
  emit_key(out, "returns");
  out.push_back(char(0x91));  // array 1
  out.push_back(char(0x82));  // map 2
  emit_key(out, "kind");
  emit_key(out, "inline");
  emit_key(out, "data");
  emit_bin_header(out, dlen);
  out.append(data, dlen);
  emit_key(out, "error");
  out.push_back(char(0xC4));  // bin 0
  out.push_back(char(0x00));
  emit_key(out, "error_text");
  out.push_back(char(0xA0));  // ""
}

// ---------------------------------------------------------------------------
// Python helpers
// ---------------------------------------------------------------------------
static PyObject *str_from(const Span &s) {
  return PyUnicode_DecodeUTF8(s.p, s.n, "replace");
}

// Classify a decoded exec frame into the tuple protocol shared with
// worker_proc (see exec_next docstring). Consumes nothing.
static PyObject *classify(long conn, uint32_t msgid, const char *method,
                          uint32_t mlen, const char *payload, uint32_t plen) {
  if (mlen == 9 && memcmp(method, "push_task", 9) == 0) {
    TaskScan ts;
    scan_task_spec(reinterpret_cast<const uint8_t *>(payload), plen, &ts);
    if (ts.parse_ok && !ts.has_ref_args && !ts.cross_language &&
        !ts.trace_present) {
      return Py_BuildValue(
          "(BlkN N N y# K y#)", 1, conn, (unsigned long)msgid,
          str_from(ts.task_id), str_from(ts.function_id), str_from(ts.name),
          ts.args.p, (Py_ssize_t)ts.args.n,
          (unsigned long long)ts.num_returns, payload, (Py_ssize_t)plen);
    }
  } else if (mlen == 15 && memcmp(method, "push_actor_task", 15) == 0) {
    ActorScan as;
    scan_actor_spec(reinterpret_cast<const uint8_t *>(payload), plen, &as);
    if (as.parse_ok && !as.has_ref_args && !as.trace_present) {
      return Py_BuildValue(
          "(BlkN N N N y# K K y#)", 2, conn, (unsigned long)msgid,
          str_from(as.task_id), str_from(as.method), str_from(as.name),
          str_from(as.caller_id), as.args.p, (Py_ssize_t)as.args.n,
          (unsigned long long)as.num_returns, (unsigned long long)as.seq,
          payload, (Py_ssize_t)plen);
    }
  }
  // Bounce: Python's full decoder + asyncio handler take over.
  return Py_BuildValue("(Blky#y#)", 3, conn, (unsigned long)msgid,
                       method, (Py_ssize_t)mlen, payload, (Py_ssize_t)plen);
}

// ---------------------------------------------------------------------------
// module methods
// ---------------------------------------------------------------------------
static PyObject *fl_attach(PyObject *, PyObject *args) {
  const char *path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  void *h = dlopen(path, RTLD_NOW | RTLD_LOCAL);
  if (!h) {
    PyErr_Format(PyExc_OSError, "dlopen(%s) failed: %s", path, dlerror());
    return nullptr;
  }
  p_exec_next = (fn_exec_next)dlsym(h, "rt_exec_next");
  p_msg_free = (fn_msg_free)dlsym(h, "rt_msg_free");
  p_send = (fn_send)dlsym(h, "rt_send");
  p_send_buf = (fn_send)dlsym(h, "rt_send_buf");
  p_exec_pending = (fn_exec_pending)dlsym(h, "rt_exec_pending");
  p_call_start = (fn_call_start)dlsym(h, "rt_call_start");
  p_call_start_buf = (fn_call_start)dlsym(h, "rt_call_start_buf");
  p_call_wait = (fn_call_wait)dlsym(h, "rt_call_wait");
  if (!p_exec_next || !p_msg_free || !p_send || !p_send_buf ||
      !p_exec_pending || !p_call_start || !p_call_start_buf || !p_call_wait) {
    PyErr_SetString(PyExc_OSError, "rt_* symbols missing from engine lib");
    return nullptr;
  }
  Py_RETURN_NONE;
}

// exec_next(engine, timeout_ms) -> None (timeout) or tuple:
//   (0, tag)                                     injected work item
//   (1, conn, msgid, task_id, function_id, name, args, num_returns, raw)
//   (2, conn, msgid, task_id, method, name, caller_id, args, num_returns,
//       seq, raw)
//   (3, conn, msgid, method, payload)            bounce to asyncio handler
//   (4,)                                         engine stopping
static PyObject *fl_exec_next(PyObject *, PyObject *args) {
  unsigned long long eng;
  int timeout_ms;
  if (!PyArg_ParseTuple(args, "Ki", &eng, &timeout_ms)) return nullptr;
  rt_msg_view v;
  int rc;
  Py_BEGIN_ALLOW_THREADS;
  rc = p_exec_next(reinterpret_cast<void *>(eng), timeout_ms, &v);
  Py_END_ALLOW_THREADS;
  if (rc == 0) Py_RETURN_NONE;
  if (rc == -1) return Py_BuildValue("(B)", 4);
  if (v.kind == kInjected) {
    uint32_t tag = v.msgid;
    p_msg_free(v.opaque);
    return Py_BuildValue("(Bk)", 0, (unsigned long)tag);
  }
  PyObject *out =
      classify(v.conn, v.msgid, v.method, v.mlen, v.payload, v.plen);
  p_msg_free(v.opaque);
  return out;
}

// probe(method: bytes, payload: bytes) -> tuple  (unit-test hook: same
// classification as exec_next with conn=0, msgid=0)
static PyObject *fl_probe(PyObject *, PyObject *args) {
  const char *method, *payload;
  Py_ssize_t mlen, plen;
  if (!PyArg_ParseTuple(args, "y#y#", &method, &mlen, &payload, &plen))
    return nullptr;
  return classify(0, 0, method, uint32_t(mlen), payload, uint32_t(plen));
}

// probe_reply(data: bytes) -> bytes  (unit-test hook: the canonical
// ok/inline TaskReply encoding — must be byte-identical to
// wire_gen.encode_task_reply)
static PyObject *fl_probe_reply(PyObject *, PyObject *args) {
  const char *data;
  Py_ssize_t dlen;
  if (!PyArg_ParseTuple(args, "y#", &data, &dlen)) return nullptr;
  std::string out;
  build_ok_inline_reply(out, data, size_t(dlen));
  return PyBytes_FromStringAndSize(out.data(), Py_ssize_t(out.size()));
}

// probe_reply_scan(payload: bytes) -> tuple  (unit-test hook: call_wait's
// REP classification: (1, data) simple, (2, raw) complex)
static PyObject *fl_probe_reply_scan(PyObject *, PyObject *args) {
  const char *payload;
  Py_ssize_t plen;
  if (!PyArg_ParseTuple(args, "y#", &payload, &plen)) return nullptr;
  ReplyScan rs;
  scan_task_reply(reinterpret_cast<const uint8_t *>(payload), plen, &rs);
  if (rs.simple) {
    return Py_BuildValue("(By#)", 1, rs.data.p, (Py_ssize_t)rs.data.n);
  }
  return Py_BuildValue("(By#)", 2, payload, plen);
}

// reply_inline(engine, conn, msgid, method: bytes, data: bytes) -> int
// Encodes the canonical ok/1-inline-return TaskReply and sends it —
// buffered behind pending exec work (coalesced writev), else inline.
static PyObject *fl_reply_inline(PyObject *, PyObject *args) {
  unsigned long long eng;
  long conn;
  unsigned long msgid;
  const char *method, *data;
  Py_ssize_t mlen, dlen;
  if (!PyArg_ParseTuple(args, "Klky#y#", &eng, &conn, &msgid, &method, &mlen,
                        &data, &dlen))
    return nullptr;
  std::string out;
  build_ok_inline_reply(out, data, size_t(dlen));
  void *e = reinterpret_cast<void *>(eng);
  fn_send sender = (p_exec_pending(e) > 0) ? p_send_buf : p_send;
  int rc = sender(e, conn, kRep, uint32_t(msgid),
                  reinterpret_cast<const uint8_t *>(method), uint32_t(mlen),
                  reinterpret_cast<const uint8_t *>(out.data()),
                  uint32_t(out.size()));
  return PyLong_FromLong(rc);
}

// reply_raw(engine, conn, msgid, method: bytes, payload: bytes) -> int
// Pre-encoded reply (error/shm/multi-return paths built in Python).
static PyObject *fl_reply_raw(PyObject *, PyObject *args) {
  unsigned long long eng;
  long conn;
  unsigned long msgid;
  const char *method, *payload;
  Py_ssize_t mlen, plen;
  if (!PyArg_ParseTuple(args, "Klky#y#", &eng, &conn, &msgid, &method, &mlen,
                        &payload, &plen))
    return nullptr;
  void *e = reinterpret_cast<void *>(eng);
  fn_send sender = (p_exec_pending(e) > 0) ? p_send_buf : p_send;
  int rc;
  if (plen > (64 << 10)) {
    Py_BEGIN_ALLOW_THREADS;
    rc = sender(e, conn, kRep, uint32_t(msgid),
                reinterpret_cast<const uint8_t *>(method), uint32_t(mlen),
                reinterpret_cast<const uint8_t *>(payload), uint32_t(plen));
    Py_END_ALLOW_THREADS;
  } else {
    rc = sender(e, conn, kRep, uint32_t(msgid),
                reinterpret_cast<const uint8_t *>(method), uint32_t(mlen),
                reinterpret_cast<const uint8_t *>(payload), uint32_t(plen));
  }
  return PyLong_FromLong(rc);
}

// submit(engine, conn, method: bytes, p0, task_id: str, p1, args: bytes,
//        p2, seq: int, seq_off: int, buffered: int) -> int handle
// Splices the canonical spec payload (p0 + str(task_id) + p1 + bin(args)
// + p2 — parts precompiled from the template by wire_gen splicers) and
// starts the native call. seq_off >= 0 patches the u32fixed seq field
// (ActorTaskSpec) at its fixed offset, like wire_gen.patch_seq.
static PyObject *fl_submit(PyObject *, PyObject *args) {
  unsigned long long eng;
  long conn;
  const char *method, *p0, *tid, *p1, *argbytes, *p2;
  Py_ssize_t mlen, p0n, tidn, p1n, argn, p2n;
  long long seq, seq_off;
  int buffered;
  if (!PyArg_ParseTuple(args, "Kly#y#s#y#y#y#LLi", &eng, &conn, &method,
                        &mlen, &p0, &p0n, &tid, &tidn, &p1, &p1n, &argbytes,
                        &argn, &p2, &p2n, &seq, &seq_off, &buffered))
    return nullptr;
  std::string payload;
  payload.reserve(size_t(p0n + p1n + p2n + tidn + argn) + 12);
  payload.append(p0, p0n);
  emit_str_header(payload, size_t(tidn));
  payload.append(tid, tidn);
  payload.append(p1, p1n);
  emit_bin_header(payload, size_t(argn));
  payload.append(argbytes, argn);
  payload.append(p2, p2n);
  if (seq_off >= 0 && size_t(seq_off) + 4 <= payload.size()) {
    uint32_t s = uint32_t(seq);
    payload[seq_off] = char(s >> 24);
    payload[seq_off + 1] = char(s >> 16);
    payload[seq_off + 2] = char(s >> 8);
    payload[seq_off + 3] = char(s);
  }
  void *e = reinterpret_cast<void *>(eng);
  fn_call_start starter = buffered ? p_call_start_buf : p_call_start;
  uint64_t handle;
  if (payload.size() > (64 << 10)) {
    Py_BEGIN_ALLOW_THREADS;
    handle = starter(e, conn, reinterpret_cast<const uint8_t *>(method),
                     uint32_t(mlen),
                     reinterpret_cast<const uint8_t *>(payload.data()),
                     uint32_t(payload.size()));
    Py_END_ALLOW_THREADS;
  } else {
    handle = starter(e, conn, reinterpret_cast<const uint8_t *>(method),
                     uint32_t(mlen),
                     reinterpret_cast<const uint8_t *>(payload.data()),
                     uint32_t(payload.size()));
  }
  return PyLong_FromUnsignedLongLong(handle);
}

// probe_splice(p0, task_id, p1, args, p2, seq, seq_off) -> bytes
// (unit-test hook: the payload fl_submit would put on the wire)
static PyObject *fl_probe_splice(PyObject *, PyObject *args) {
  const char *p0, *tid, *p1, *argbytes, *p2;
  Py_ssize_t p0n, tidn, p1n, argn, p2n;
  long long seq, seq_off;
  if (!PyArg_ParseTuple(args, "y#s#y#y#y#LL", &p0, &p0n, &tid, &tidn, &p1,
                        &p1n, &argbytes, &argn, &p2, &p2n, &seq, &seq_off))
    return nullptr;
  std::string payload;
  payload.reserve(size_t(p0n + p1n + p2n + tidn + argn) + 12);
  payload.append(p0, p0n);
  emit_str_header(payload, size_t(tidn));
  payload.append(tid, tidn);
  payload.append(p1, p1n);
  emit_bin_header(payload, size_t(argn));
  payload.append(argbytes, argn);
  payload.append(p2, p2n);
  if (seq_off >= 0 && size_t(seq_off) + 4 <= payload.size()) {
    uint32_t s = uint32_t(seq);
    payload[seq_off] = char(s >> 24);
    payload[seq_off + 1] = char(s >> 16);
    payload[seq_off + 2] = char(s >> 8);
    payload[seq_off + 3] = char(s);
  }
  return PyBytes_FromStringAndSize(payload.data(),
                                   Py_ssize_t(payload.size()));
}

// call_wait(engine, handle, timeout_ms) -> tuple:
//   (0,) timeout   (-1,) conn lost   (-2,) unknown handle
//   (1, data)  ok + exactly one inline return (the fast settle)
//   (2, raw)   any other REP payload → Python decode_task_reply
//   (3, err)   transport-level ERR frame
static PyObject *fl_call_wait(PyObject *, PyObject *args) {
  unsigned long long eng;
  unsigned long long handle;
  int timeout_ms;
  if (!PyArg_ParseTuple(args, "KKi", &eng, &handle, &timeout_ms))
    return nullptr;
  rt_msg_view v;
  int rc;
  Py_BEGIN_ALLOW_THREADS;
  rc = p_call_wait(reinterpret_cast<void *>(eng), handle, timeout_ms, &v);
  Py_END_ALLOW_THREADS;
  if (rc != 1) return Py_BuildValue("(i)", rc);
  PyObject *out;
  if (v.kind == kErr) {
    out = Py_BuildValue("(By#)", 3, v.payload, (Py_ssize_t)v.plen);
  } else {
    ReplyScan rs;
    scan_task_reply(reinterpret_cast<const uint8_t *>(v.payload), v.plen,
                    &rs);
    if (rs.simple) {
      out = Py_BuildValue("(By#)", 1, rs.data.p, (Py_ssize_t)rs.data.n);
    } else {
      out = Py_BuildValue("(By#)", 2, v.payload, (Py_ssize_t)v.plen);
    }
  }
  p_msg_free(v.opaque);
  return out;
}

static PyMethodDef Methods[] = {
    {"attach", fl_attach, METH_VARARGS, "dlopen engine lib + resolve rt_*"},
    {"exec_next", fl_exec_next, METH_VARARGS, "next exec frame, decoded"},
    {"probe", fl_probe, METH_VARARGS, "classify a frame (test hook)"},
    {"probe_reply", fl_probe_reply, METH_VARARGS,
     "encode ok/inline reply (test hook)"},
    {"probe_reply_scan", fl_probe_reply_scan, METH_VARARGS,
     "classify a REP payload (test hook)"},
    {"reply_inline", fl_reply_inline, METH_VARARGS,
     "encode+send ok/inline TaskReply"},
    {"reply_raw", fl_reply_raw, METH_VARARGS, "send pre-encoded reply"},
    {"submit", fl_submit, METH_VARARGS, "splice spec + start native call"},
    {"probe_splice", fl_probe_splice, METH_VARARGS,
     "splice a spec payload (test hook)"},
    {"call_wait", fl_call_wait, METH_VARARGS, "wait + decode reply"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef Module = {
    PyModuleDef_HEAD_INIT, "_fastlane",
    "Native per-task hot path (decode/dispatch/reply in C++).", -1, Methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastlane(void) { return PyModule_Create(&Module); }
