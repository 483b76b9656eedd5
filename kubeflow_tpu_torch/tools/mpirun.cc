// Minimal local `mpirun`: the OpenMPI launcher CLI contract, single-host.
//
// Upstream analogue (UNVERIFIED, SURVEY.md §2a MPIJob row): the `mpirun`
// binary the MPIJob Launcher pod execs.  The port's copy of
// kubeflow_tpu/tools/mpirun.cc.  The image ships no MPI runtime, so
// this vendored tool implements the subset of the CLI the MPIJob
// controller's generated command line and hostfile actually exercise:
//
//   mpirun [--allow-run-as-root] [--oversubscribe] [-np N]
//          [--host h:s[,h:s...]] [--hostfile|-hostfile PATH]
//          [-x ENV[=VAL]] CMD ARGS...
//
// Semantics: every rank is forked LOCALLY (this box cannot ssh to pod
// "hosts"; slots are summed from --host/--hostfile, -np wins when given),
// with the env OpenMPI programs read: OMPI_COMM_WORLD_RANK / _SIZE /
// _LOCAL_RANK / _LOCAL_SIZE plus PMI_RANK / PMI_SIZE.  Exit status is the
// first non-zero child status.  It is a CONTRACT-TEST tool: it proves the
// controller's launcher command line, hostfile rendering, and env plumbing
// drive a real mpirun-shaped executable — it performs no MPI communication
// itself (ranks use their own transport, e.g. torch.distributed or the
// transport shim).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <fstream>
#include <sstream>
#include <sys/wait.h>
#include <unistd.h>

static int slots_of(const std::string& spec) {
  // "host" or "host:slots"
  auto c = spec.find(':');
  if (c == std::string::npos) return 1;
  int s = atoi(spec.c_str() + c + 1);
  return s > 0 ? s : 1;
}

int main(int argc, char** argv) {
  int np = -1;
  int hosted_slots = 0;
  std::vector<char*> cmd;
  std::vector<std::string> exports;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--allow-run-as-root" || a == "--oversubscribe" ||
        a == "--bind-to" || a == "--map-by") {
      if ((a == "--bind-to" || a == "--map-by") && i + 1 < argc) i++;
      continue;  // accepted, no-op locally
    } else if ((a == "-np" || a == "--np" || a == "-n") && i + 1 < argc) {
      np = atoi(argv[++i]);
    } else if ((a == "--host" || a == "-H") && i + 1 < argc) {
      std::stringstream ss(argv[++i]);
      std::string h;
      while (std::getline(ss, h, ',')) hosted_slots += slots_of(h);
    } else if ((a == "--hostfile" || a == "-hostfile" || a == "--machinefile") &&
               i + 1 < argc) {
      std::ifstream f(argv[++i]);
      if (!f) { fprintf(stderr, "mpirun: cannot read hostfile %s\n", argv[i]); return 1; }
      std::string line;
      while (std::getline(f, line)) {
        // "host slots=N" (OpenMPI hostfile format) or bare "host"
        if (line.empty() || line[0] == '#') continue;
        auto sl = line.find("slots=");
        hosted_slots += sl == std::string::npos ? 1 : std::max(1, atoi(line.c_str() + sl + 6));
      }
    } else if (a == "-x" && i + 1 < argc) {
      exports.push_back(argv[++i]);  // ENV or ENV=VAL
    } else if (a == "--help") {
      printf("minimal local mpirun (vendored contract tool)\n");
      return 0;
    } else {
      for (int j = i; j < argc; j++) cmd.push_back(argv[j]);
      break;
    }
  }
  if (cmd.empty()) { fprintf(stderr, "mpirun: no command given\n"); return 1; }
  cmd.push_back(nullptr);
  int size = np > 0 ? np : (hosted_slots > 0 ? hosted_slots : 1);

  for (const auto& e : exports) {
    auto eq = e.find('=');
    if (eq != std::string::npos)
      setenv(e.substr(0, eq).c_str(), e.c_str() + eq + 1, 1);
    // bare "-x NAME" re-exports the launcher's value: already inherited
  }

  std::vector<pid_t> kids;
  for (int r = 0; r < size; r++) {
    pid_t pid = fork();
    if (pid < 0) { perror("mpirun: fork"); return 1; }
    if (pid == 0) {
      char buf[32];
      snprintf(buf, sizeof buf, "%d", r);
      setenv("OMPI_COMM_WORLD_RANK", buf, 1);
      setenv("OMPI_COMM_WORLD_LOCAL_RANK", buf, 1);
      setenv("PMI_RANK", buf, 1);
      snprintf(buf, sizeof buf, "%d", size);
      setenv("OMPI_COMM_WORLD_SIZE", buf, 1);
      setenv("OMPI_COMM_WORLD_LOCAL_SIZE", buf, 1);
      setenv("PMI_SIZE", buf, 1);
      execvp(cmd[0], cmd.data());
      fprintf(stderr, "mpirun: exec %s: %s\n", cmd[0], strerror(errno));
      _exit(127);
    }
    kids.push_back(pid);
  }
  int rc = 0;
  for (pid_t pid : kids) {
    int st = 0;
    waitpid(pid, &st, 0);
    int code = WIFEXITED(st) ? WEXITSTATUS(st) : 128 + WTERMSIG(st);
    if (code != 0 && rc == 0) rc = code;
  }
  return rc;
}
