// Katib observation-log store core (db-manager equivalent).
//
// Role in the stack (SURVEY.md §2a "Katib: db-manager + UI" row): upstream
// Katib runs a Go gRPC façade (ReportObservationLog / GetObservationLog)
// over MySQL — a native store — so intermediate metric time series survive
// trial pod GC and back both early stopping and the UI.  This is the
// TPU-native rebuild's equivalent native core: per-(trial, metric) series
// with an append-only WAL for crash-safe persistence, bound from Python via
// ctypes (obslog.py).  Same WAL framing as metadata_core.cc: u8 op |
// u32 payload_len | payload; truncated tails are dropped at replay.
//
// WAL payload (op OP_REPORT): lp(trial) | lp(metric) | i64 step | f64 value
// where lp(s) = u32 length + bytes, little-endian.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Point {
  int64_t step;
  double value;
};

void put_u32(std::string* out, uint32_t v) { out->append(reinterpret_cast<char*>(&v), 4); }
void put_i64(std::string* out, int64_t v) { out->append(reinterpret_cast<char*>(&v), 8); }
void put_f64(std::string* out, double v) { out->append(reinterpret_cast<char*>(&v), 8); }
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
  double f64() {
    if (p + 8 > end) { ok = false; return 0.0; }
    double v; std::memcpy(&v, p, 8); p += 8; return v;
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

  // trial + '\0' + metric → ordered series
  std::unordered_map<std::string, std::vector<Point>> series;
  // insertion-ordered trial list and per-trial metric list (UI listings are
  // deterministic; std::map keeps metric names sorted per trial)
  std::vector<std::string> trials;
  std::unordered_map<std::string, std::map<std::string, int>> trial_metrics;

  std::string scratch;  // last query result, drained by obs_read_buffer
};

enum Op : uint8_t { OP_REPORT = 1 };

void apply(Store* st, uint8_t op, const std::string& payload) {
  if (op != OP_REPORT) return;
  Reader r{payload.data(), payload.data() + payload.size()};
  std::string trial = r.lp();
  std::string metric = r.lp();
  int64_t step = r.i64();
  double value = r.f64();
  if (!r.ok) return;
  if (!st->trial_metrics.count(trial)) st->trials.push_back(trial);
  st->trial_metrics[trial][metric] += 1;
  st->series[trial + '\0' + metric].push_back(Point{step, value});
}

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

}  // namespace

extern "C" {

void* obs_open(const char* path) {
  auto* st = new Store();
  st->wal_path = cstr(path);
  if (!st->wal_path.empty()) {
    replay(st);
    st->wal = fopen(st->wal_path.c_str(), "ab");
    if (!st->wal) { delete st; return nullptr; }
  }
  return st;
}

void obs_close(void* h) {
  auto* st = static_cast<Store*>(h);
  if (st->wal) fclose(st->wal);
  delete st;
}

int32_t obs_report(void* h, const char* trial, const char* metric, int64_t step, double value) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  std::string payload;
  put_lp(&payload, cstr(trial));
  put_lp(&payload, cstr(metric));
  put_i64(&payload, step);
  put_f64(&payload, value);
  apply(st, OP_REPORT, payload);
  wal_append(st, OP_REPORT, payload);
  return 0;
}

int64_t obs_count(void* h, const char* trial, const char* metric) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->series.find(cstr(trial) + '\0' + cstr(metric));
  return it == st->series.end() ? 0 : static_cast<int64_t>(it->second.size());
}

// Series query from `start`: scratch = repeated (i64 step | f64 value).
int64_t obs_get_log(void* h, const char* trial, const char* metric, int64_t start) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  st->scratch.clear();
  auto it = st->series.find(cstr(trial) + '\0' + cstr(metric));
  if (it != st->series.end()) {
    for (size_t i = start < 0 ? 0 : static_cast<size_t>(start); i < it->second.size(); ++i) {
      put_i64(&st->scratch, it->second[i].step);
      put_f64(&st->scratch, it->second[i].value);
    }
  }
  return static_cast<int64_t>(st->scratch.size());
}

int32_t obs_latest(void* h, const char* trial, const char* metric, double* out) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  auto it = st->series.find(cstr(trial) + '\0' + cstr(metric));
  if (it == st->series.end() || it->second.empty()) return 0;
  *out = it->second.back().value;
  return 1;
}

// Newline-joined trial names (insertion order) into scratch.
int64_t obs_trials(void* h) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  st->scratch.clear();
  for (const auto& t : st->trials) {
    st->scratch.append(t);
    st->scratch.push_back('\n');
  }
  return static_cast<int64_t>(st->scratch.size());
}

// Newline-joined metric names for one trial (sorted) into scratch.
int64_t obs_metrics(void* h, const char* trial) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  st->scratch.clear();
  auto it = st->trial_metrics.find(cstr(trial));
  if (it != st->trial_metrics.end()) {
    for (const auto& kv : it->second) {
      st->scratch.append(kv.first);
      st->scratch.push_back('\n');
    }
  }
  return static_cast<int64_t>(st->scratch.size());
}

int64_t obs_read_buffer(void* h, char* out, int64_t cap) {
  auto* st = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lk(st->mu);
  int64_t n = static_cast<int64_t>(st->scratch.size());
  if (n > cap) n = cap;
  std::memcpy(out, st->scratch.data(), static_cast<size_t>(n));
  return n;
}

}  // extern "C"
