// MLMD-equivalent metadata store core.
//
// Role in the stack (SURVEY.md §2b): the reference's KFP v2 driver talks to
// ML Metadata, a C++ gRPC server backed by SQLite/MySQL.  This is the
// TPU-native rebuild's equivalent native core: a C++ storage engine holding
// artifacts / executions / contexts / events / associations with typed
// indexes and an append-only WAL for crash-safe persistence.  The Python
// client (metadata.py) binds via ctypes (no pybind11 in this image) and owns
// only JSON property (de)serialization — ids, indexing, lineage adjacency,
// durability and thread-safety all live here.
//
// Record wire format (core → Python), little-endian:
//   artifact:  i64 id | u32 state | lp(type) | lp(uri) | lp(props)
//   execution: i64 id | u32 state | lp(type) | lp(fingerprint) | lp(props)
//   context:   i64 id | u32 zero  | lp(type) | lp(name) | lp(props)
//   event:     i64 execution_id | i64 artifact_id | u32 type | lp(path)
// where lp(s) = u32 length + bytes.  The WAL stores one byte of op-tag plus
// the same serialization; replay rebuilds every index.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Artifact {
  int64_t id;
  uint32_t state;
  std::string type, uri, props;
};

struct Execution {
  int64_t id;
  uint32_t state;
  std::string type, fingerprint, props;
};

struct Context {
  int64_t id;
  std::string type, name, props;
};

struct Event {
  int64_t execution_id, artifact_id;
  uint32_t type;  // 0=INPUT 1=OUTPUT
  std::string path;
};

void put_u32(std::string* out, uint32_t v) { out->append(reinterpret_cast<char*>(&v), 4); }
void put_i64(std::string* out, int64_t v) { out->append(reinterpret_cast<char*>(&v), 8); }
void put_lp(std::string* out, const std::string& s) {
  put_u32(out, static_cast<uint32_t>(s.size()));
  out->append(s);
}

struct Reader {
  const char* p;
  const char* end;
  bool ok = true;
  uint32_t u32() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v; std::memcpy(&v, p, 4); p += 4; return v;
  }
  int64_t i64() {
    if (p + 8 > end) { ok = false; return 0; }
    int64_t v; std::memcpy(&v, p, 8); p += 8; return v;
  }
  std::string lp() {
    uint32_t n = u32();
    if (!ok || p + n > end) { ok = false; return ""; }
    std::string s(p, n); p += n; return s;
  }
};

struct Store {
  std::mutex mu;
  std::string wal_path;  // empty → in-memory only
  FILE* wal = nullptr;
  int64_t next_id = 1;

  std::unordered_map<int64_t, Artifact> artifacts;
  std::unordered_map<int64_t, Execution> executions;
  std::unordered_map<int64_t, Context> contexts;
  std::vector<Event> events;

  std::unordered_map<std::string, std::vector<int64_t>> artifacts_by_type;
  std::unordered_map<std::string, std::vector<int64_t>> executions_by_type;
  std::unordered_map<std::string, std::vector<int64_t>> executions_by_fp;
  std::unordered_map<std::string, std::vector<int64_t>> contexts_by_type;
  std::unordered_map<std::string, int64_t> context_by_key;  // type + '\0' + name
  std::unordered_map<int64_t, std::vector<int64_t>> events_by_execution;  // -> event idx
  std::unordered_map<int64_t, std::vector<int64_t>> events_by_artifact;
  std::unordered_map<int64_t, std::vector<int64_t>> execs_by_context;
  std::unordered_map<int64_t, std::vector<int64_t>> artifacts_by_context;

  std::string scratch;  // last query result, drained by mds_read_buffer
};

enum Op : uint8_t {
  OP_ARTIFACT = 1,
  OP_EXECUTION = 2,
  OP_CONTEXT = 3,
  OP_EVENT = 4,
  OP_ASSOCIATION = 5,
  OP_ATTRIBUTION = 6,
};

std::string ser_artifact(const Artifact& a) {
  std::string s;
  put_i64(&s, a.id);
  put_u32(&s, a.state);
  put_lp(&s, a.type);
  put_lp(&s, a.uri);
  put_lp(&s, a.props);
  return s;
}

std::string ser_execution(const Execution& e) {
  std::string s;
  put_i64(&s, e.id);
  put_u32(&s, e.state);
  put_lp(&s, e.type);
  put_lp(&s, e.fingerprint);
  put_lp(&s, e.props);
  return s;
}

std::string ser_context(const Context& c) {
  std::string s;
  put_i64(&s, c.id);
  put_u32(&s, 0);
  put_lp(&s, c.type);
  put_lp(&s, c.name);
  put_lp(&s, c.props);
  return s;
}

std::string ser_event(const Event& e) {
  std::string s;
  put_i64(&s, e.execution_id);
  put_i64(&s, e.artifact_id);
  put_u32(&s, e.type);
  put_lp(&s, e.path);
  return s;
}

void erase_id(std::vector<int64_t>& v, int64_t id) {
  for (size_t i = 0; i < v.size(); ++i) {
    if (v[i] == id) { v.erase(v.begin() + i); return; }
  }
}

// Apply a deserialized op to the in-memory state (used by both the write path
// and WAL replay, so the two can never diverge).
void apply(Store* st, uint8_t op, const std::string& payload) {
  Reader r{payload.data(), payload.data() + payload.size()};
  switch (op) {
    case OP_ARTIFACT: {
      Artifact a;
      a.id = r.i64(); a.state = r.u32(); a.type = r.lp(); a.uri = r.lp(); a.props = r.lp();
      if (!r.ok) return;
      auto it = st->artifacts.find(a.id);
      if (it == st->artifacts.end()) {
        st->artifacts_by_type[a.type].push_back(a.id);
      } else if (it->second.type != a.type) {
        erase_id(st->artifacts_by_type[it->second.type], a.id);
        st->artifacts_by_type[a.type].push_back(a.id);
      }
      if (a.id >= st->next_id) st->next_id = a.id + 1;
      st->artifacts[a.id] = std::move(a);
      break;
    }
    case OP_EXECUTION: {
      Execution e;
      e.id = r.i64(); e.state = r.u32(); e.type = r.lp(); e.fingerprint = r.lp(); e.props = r.lp();
      if (!r.ok) return;
      auto it = st->executions.find(e.id);
      if (it == st->executions.end()) {
        st->executions_by_type[e.type].push_back(e.id);
        if (!e.fingerprint.empty()) st->executions_by_fp[e.fingerprint].push_back(e.id);
      } else {
        if (it->second.type != e.type) {
          erase_id(st->executions_by_type[it->second.type], e.id);
          st->executions_by_type[e.type].push_back(e.id);
        }
        if (it->second.fingerprint != e.fingerprint) {
          if (!it->second.fingerprint.empty())
            erase_id(st->executions_by_fp[it->second.fingerprint], e.id);
          if (!e.fingerprint.empty()) st->executions_by_fp[e.fingerprint].push_back(e.id);
        }
      }
      if (e.id >= st->next_id) st->next_id = e.id + 1;
      st->executions[e.id] = std::move(e);
      break;
    }
    case OP_CONTEXT: {
      Context c;
      c.id = r.i64(); r.u32(); c.type = r.lp(); c.name = r.lp(); c.props = r.lp();
      if (!r.ok) return;
      if (!st->contexts.count(c.id)) st->contexts_by_type[c.type].push_back(c.id);
      st->context_by_key[c.type + '\0' + c.name] = c.id;
      if (c.id >= st->next_id) st->next_id = c.id + 1;
      st->contexts[c.id] = std::move(c);
      break;
    }
    case OP_EVENT: {
      Event e;
      e.execution_id = r.i64(); e.artifact_id = r.i64(); e.type = r.u32(); e.path = r.lp();
      if (!r.ok) return;
      int64_t idx = static_cast<int64_t>(st->events.size());
      st->events_by_execution[e.execution_id].push_back(idx);
      st->events_by_artifact[e.artifact_id].push_back(idx);
      st->events.push_back(std::move(e));
      break;
    }
    case OP_ASSOCIATION: {
      int64_t ctx = r.i64(), exec = r.i64();
      if (!r.ok) return;
      auto& v = st->execs_by_context[ctx];
      bool dup = false;
      for (int64_t id : v) dup = dup || id == exec;
      if (!dup) v.push_back(exec);
      break;
    }
    case OP_ATTRIBUTION: {
      int64_t ctx = r.i64(), art = r.i64();
      if (!r.ok) return;
      auto& v = st->artifacts_by_context[ctx];
      bool dup = false;
      for (int64_t id : v) dup = dup || id == art;
      if (!dup) v.push_back(art);
      break;
    }
  }
}

// WAL record: u8 op | u32 payload_len | payload.  Truncated tails (crash mid
// write) are dropped at replay.
void wal_append(Store* st, uint8_t op, const std::string& payload) {
  if (!st->wal) return;
  uint32_t n = static_cast<uint32_t>(payload.size());
  fwrite(&op, 1, 1, st->wal);
  fwrite(&n, 4, 1, st->wal);
  fwrite(payload.data(), 1, n, st->wal);
  fflush(st->wal);
}

void replay(Store* st) {
  FILE* f = fopen(st->wal_path.c_str(), "rb");
  if (!f) return;
  std::string payload;
  for (;;) {
    uint8_t op;
    uint32_t n;
    if (fread(&op, 1, 1, f) != 1) break;
    if (fread(&n, 4, 1, f) != 1) break;
    payload.resize(n);
    if (n && fread(&payload[0], 1, n, f) != n) break;
    apply(st, op, payload);
  }
  fclose(f);
}

std::string cstr(const char* s) { return s ? std::string(s) : std::string(); }

void list_ids(Store* st, const std::vector<int64_t>* ids) {
  st->scratch.clear();
  if (ids) {
    for (int64_t id : *ids) put_i64(&st->scratch, id);
  }
}

}  // namespace

extern "C" {

void* mds_open(const char* path) {
  auto* st = new Store();
  st->wal_path = cstr(path);
  if (!st->wal_path.empty()) {
    replay(st);
    st->wal = fopen(st->wal_path.c_str(), "ab");
    if (!st->wal) { delete st; return nullptr; }
  }
  return st;
}

void mds_close(void* h) {
  auto* st = static_cast<Store*>(h);
  if (st->wal) fclose(st->wal);
  delete st;
}

int64_t mds_put_artifact(void* h, int64_t id, const char* type, const char* uri,
                         int32_t state, const char* props, int32_t props_len) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  Artifact a;
  a.id = id >= 0 ? id : st->next_id;
  a.state = static_cast<uint32_t>(state);
  a.type = cstr(type);
  a.uri = cstr(uri);
  a.props.assign(props ? props : "", static_cast<size_t>(props_len));
  if (id >= 0 && !st->artifacts.count(id)) return -1;  // update of unknown id
  std::string payload = ser_artifact(a);
  apply(st, OP_ARTIFACT, payload);
  wal_append(st, OP_ARTIFACT, payload);
  return a.id;
}

int64_t mds_put_execution(void* h, int64_t id, const char* type, int32_t state,
                          const char* fingerprint, const char* props, int32_t props_len) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  Execution e;
  e.id = id >= 0 ? id : st->next_id;
  e.state = static_cast<uint32_t>(state);
  e.type = cstr(type);
  e.fingerprint = cstr(fingerprint);
  e.props.assign(props ? props : "", static_cast<size_t>(props_len));
  if (id >= 0 && !st->executions.count(id)) return -1;
  std::string payload = ser_execution(e);
  apply(st, OP_EXECUTION, payload);
  wal_append(st, OP_EXECUTION, payload);
  return e.id;
}

int64_t mds_put_context(void* h, const char* type, const char* name,
                        const char* props, int32_t props_len) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  std::string key = cstr(type) + '\0' + cstr(name);
  Context c;
  auto it = st->context_by_key.find(key);
  c.id = it != st->context_by_key.end() ? it->second : st->next_id;
  c.type = cstr(type);
  c.name = cstr(name);
  c.props.assign(props ? props : "", static_cast<size_t>(props_len));
  std::string payload = ser_context(c);
  apply(st, OP_CONTEXT, payload);
  wal_append(st, OP_CONTEXT, payload);
  return c.id;
}

int32_t mds_put_event(void* h, int64_t execution_id, int64_t artifact_id,
                      int32_t type, const char* path) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  if (!st->executions.count(execution_id) || !st->artifacts.count(artifact_id)) return -1;
  Event e{execution_id, artifact_id, static_cast<uint32_t>(type), cstr(path)};
  std::string payload = ser_event(e);
  apply(st, OP_EVENT, payload);
  wal_append(st, OP_EVENT, payload);
  return 0;
}

int32_t mds_put_association(void* h, int64_t context_id, int64_t execution_id) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  if (!st->contexts.count(context_id) || !st->executions.count(execution_id)) return -1;
  std::string payload;
  put_i64(&payload, context_id);
  put_i64(&payload, execution_id);
  apply(st, OP_ASSOCIATION, payload);
  wal_append(st, OP_ASSOCIATION, payload);
  return 0;
}

int32_t mds_put_attribution(void* h, int64_t context_id, int64_t artifact_id) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  if (!st->contexts.count(context_id) || !st->artifacts.count(artifact_id)) return -1;
  std::string payload;
  put_i64(&payload, context_id);
  put_i64(&payload, artifact_id);
  apply(st, OP_ATTRIBUTION, payload);
  wal_append(st, OP_ATTRIBUTION, payload);
  return 0;
}

// ---- queries: each fills the scratch buffer and returns its length --------

int64_t mds_get_artifact(void* h, int64_t id) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->artifacts.find(id);
  st->scratch = it == st->artifacts.end() ? "" : ser_artifact(it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_get_execution(void* h, int64_t id) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->executions.find(id);
  st->scratch = it == st->executions.end() ? "" : ser_execution(it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_get_context(void* h, int64_t id) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->contexts.find(id);
  st->scratch = it == st->contexts.end() ? "" : ser_context(it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_context_id_by_name(void* h, const char* type, const char* name) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->context_by_key.find(cstr(type) + '\0' + cstr(name));
  return it == st->context_by_key.end() ? -1 : it->second;
}

int64_t mds_artifacts_by_type(void* h, const char* type) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->artifacts_by_type.find(cstr(type));
  list_ids(st, it == st->artifacts_by_type.end() ? nullptr : &it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_executions_by_type(void* h, const char* type) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->executions_by_type.find(cstr(type));
  list_ids(st, it == st->executions_by_type.end() ? nullptr : &it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_contexts_by_type(void* h, const char* type) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->contexts_by_type.find(cstr(type));
  list_ids(st, it == st->contexts_by_type.end() ? nullptr : &it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_executions_by_fingerprint(void* h, const char* fp) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->executions_by_fp.find(cstr(fp));
  list_ids(st, it == st->executions_by_fp.end() ? nullptr : &it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_executions_by_context(void* h, int64_t ctx) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->execs_by_context.find(ctx);
  list_ids(st, it == st->execs_by_context.end() ? nullptr : &it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_artifacts_by_context(void* h, int64_t ctx) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->artifacts_by_context.find(ctx);
  list_ids(st, it == st->artifacts_by_context.end() ? nullptr : &it->second);
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_events_by_execution(void* h, int64_t exec) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  st->scratch.clear();
  auto it = st->events_by_execution.find(exec);
  if (it != st->events_by_execution.end()) {
    for (int64_t idx : it->second) {
      std::string rec = ser_event(st->events[idx]);
      put_u32(&st->scratch, static_cast<uint32_t>(rec.size()));
      st->scratch.append(rec);
    }
  }
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_events_by_artifact(void* h, int64_t art) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  st->scratch.clear();
  auto it = st->events_by_artifact.find(art);
  if (it != st->events_by_artifact.end()) {
    for (int64_t idx : it->second) {
      std::string rec = ser_event(st->events[idx]);
      put_u32(&st->scratch, static_cast<uint32_t>(rec.size()));
      st->scratch.append(rec);
    }
  }
  return static_cast<int64_t>(st->scratch.size());
}

int64_t mds_read_buffer(void* h, char* out, int64_t cap) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  int64_t n = static_cast<int64_t>(st->scratch.size());
  if (n > cap) n = cap;
  std::memcpy(out, st->scratch.data(), static_cast<size_t>(n));
  return n;
}

int64_t mds_count(void* h, int32_t what) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  switch (what) {
    case 0: return static_cast<int64_t>(st->artifacts.size());
    case 1: return static_cast<int64_t>(st->executions.size());
    case 2: return static_cast<int64_t>(st->contexts.size());
    case 3: return static_cast<int64_t>(st->events.size());
  }
  return -1;
}

}  // extern "C"
