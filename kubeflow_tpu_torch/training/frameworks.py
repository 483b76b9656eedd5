"""Per-framework job controllers: rendezvous env injection.

The port's copy of ``kubeflow_tpu/training/frameworks.py``: all eight
controllers, rendering the rendezvous env the JAX operator renders, which
the port's workers read (``parallel/distributed.py`` ``read_env``).  The
TPU branches of ``TPUJobController`` (``TPU_ACCELERATOR_TYPE``,
``TPU_TOPOLOGY``, ``TPU_CHIPS_PER_HOST`` and the multislice
``MEGASCALE_*`` variables) need ``spec.tpu``, which the port refuses
(training/common.py): they are not rendered, and ``TPU_WORKER_ID`` is the
process index.

Upstream analogue (UNVERIFIED, SURVEY.md §2a/§3.1): each framework controller
overrides ``SetClusterSpec`` — TFJob renders ``TF_CONFIG``, PyTorchJob renders
``MASTER_ADDR``/``RANK``, etc.  The TPU-native centerpiece is
``TPUJobController``: it injects the ``jax.distributed`` coordinator plus
``MEGASCALE_*`` multislice env — the direct analogue of the reference's
``MASTER_ADDR``/``TF_CONFIG`` injection and "the single most important
mechanism to replicate" (SURVEY.md §2c).

In the simulator every host is 127.0.0.1; on a real cluster the same code
would emit the headless-Service DNS names created by the common controller.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from ..core.api import AlreadyExists, APIServer, Obj, owner_reference
from ..core.controller import Result
from .common import JobController


def _host(job: Obj, rtype: str, index: int) -> str:
    """Rendezvous hostname for one replica.

    Default (the simulator, where every pod is a localhost process) is
    127.0.0.1.  ``spec.network.hostMode: dns`` renders the headless-Service
    DNS names a real deployment uses — `{job}-{rtype}-{i}.{ns}.svc.{domain}`,
    matching the per-replica Services the common controller creates
    (common.py `_ensure_service`), so the Service objects are load-bearing
    API surface, not cosmetic parity.
    """
    net = job["spec"].get("network") or {}
    if net.get("hostMode") == "dns":
        ns = job["metadata"].get("namespace", "default")
        domain = net.get("clusterDomain", "cluster.local")
        return f"{job['metadata']['name']}-{rtype.lower()}-{index}.{ns}.svc.{domain}"
    return "127.0.0.1"


class TPUJobController(JobController):
    """TPUJob/JAXJob: the JAX rendezvous variables, which the port's workers
    join ``torch.distributed`` from."""

    kind = "TPUJob"
    gang_restart = True  # one chip down = whole-slice restart (SURVEY.md §5)

    def num_ports(self, total: int) -> int:
        return 2  # [jax coordinator, megascale coordinator] as the JAX operator

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        ports = self.ports_of(job)
        n = replicas["Worker"]["replicas"]
        env = {
            "JAX_COORDINATOR_ADDRESS": f"{_host(job, rtype, 0)}:{ports[0]}",
            "JAX_NUM_PROCESSES": str(n),
            "JAX_PROCESS_ID": str(index),
            "TPU_WORKER_ID": str(index),
            "TPU_WORKER_HOSTNAMES": ",".join(_host(job, rtype, i) for i in range(n)),
        }
        profile = job["spec"].get("profile") or {}
        if profile.get("enabled"):
            # first-class XLA profiler surfacing (SURVEY.md §5): workloads
            # pick these up via parallel.profiling.maybe_trace
            env["TPU_PROFILE_DIR"] = profile.get(
                "dir", os.path.join(tempfile.gettempdir(), "tpu-profiles"))
            env["TPU_PROFILE_STEPS"] = str(profile.get("steps", 5))
        ckpt = job["spec"].get("checkpoint") or {}
        if ckpt.get("dir"):
            # first-class checkpoint/auto-resume (SURVEY.md §5 checkpoint
            # row): runners restore_latest() on start when this is set, so a
            # gang restart resumes from step N instead of step 0
            env["CHECKPOINT_DIR"] = ckpt["dir"]
            env["CHECKPOINT_EVERY"] = str(ckpt.get("everySteps", 1000))
        preset = job["spec"].get("parallelism") or {}
        if preset.get("preset"):
            env["TPU_PARALLELISM_PRESET"] = preset["preset"]
            if preset.get("tensor"):
                env["TPU_TENSOR_PARALLEL"] = str(preset["tensor"])
        return env


class JAXJobController(TPUJobController):
    kind = "JAXJob"


class TFJobController(JobController):
    """TFJob: TF_CONFIG cluster-spec env (PS/Worker/Chief/Evaluator)."""

    kind = "TFJob"

    _ORDER = ("Chief", "Master", "PS", "Worker", "Evaluator")

    def num_ports(self, total: int) -> int:
        return total

    def _cluster(self, job: Obj, replicas: dict) -> dict[str, list[str]]:
        ports = self.ports_of(job)
        cluster: dict[str, list[str]] = {}
        p = 0
        for rtype in self._ORDER:
            if rtype not in replicas:
                continue
            addrs = []
            for i in range(replicas[rtype]["replicas"]):
                addrs.append(f"{_host(job, rtype, i)}:{ports[p]}")
                p += 1
            cluster[rtype.lower()] = addrs
        return cluster

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        tf_config = {
            "cluster": self._cluster(job, replicas),
            "task": {"type": rtype.lower(), "index": index},
        }
        return {"TF_CONFIG": json.dumps(tf_config)}


class PyTorchJobController(JobController):
    """PyTorchJob: MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK (DDP rendezvous).

    On the reference this fronts NCCL; here the same env boots
    ``torch.distributed``: gloo where processes share a card, NCCL where
    each has its own (the port's ``parallel/distributed.py``).
    """

    kind = "PyTorchJob"

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        ports = self.ports_of(job)
        has_master = "Master" in replicas
        world = sum(r["replicas"] for r in replicas.values())
        if rtype == "Master":
            rank = 0
        else:
            rank = index + (1 if has_master else 0)
        # per-rank host list (rank order: Master then Workers) — the hostfile
        # analogue the C++ transport shim (the port's transport/) uses to
        # dial its ring neighbor on multi-pod gangs
        hosts = []
        if has_master:
            hosts.append(_host(job, "Master", 0))
        for i in range(replicas.get("Worker", {}).get("replicas", 0)):
            hosts.append(_host(job, "Worker", i))
        env = {
            "MASTER_ADDR": _host(job, "Master" if has_master else "Worker", 0),
            "MASTER_PORT": str(ports[0]),
            "WORLD_SIZE": str(world),
            "RANK": str(rank),
            "LOCAL_RANK": "0",
            "TRANSPORT_HOSTS": ",".join(hosts),
        }
        elastic = job["spec"].get("elasticPolicy") or {}
        if elastic:
            # torchrun-style rendezvous bounds (upstream ElasticPolicy surface)
            env["PET_MIN_REPLICAS"] = str(elastic.get("minReplicas", 1))
            env["PET_MAX_REPLICAS"] = str(elastic.get("maxReplicas", world))
            env["PET_RDZV_ENDPOINT"] = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        return env

    def absorb_failure(self, job: Obj, status: dict, rtype: str, index: int,
                       pod: Obj, rc) -> bool:
        """ElasticPolicy: a dead Worker shrinks the world instead of failing
        the job, down to minReplicas (upstream: torchrun re-rendezvous)."""
        elastic = job["spec"].get("elasticPolicy") or {}
        if not elastic or rtype != "Worker":
            return False
        current = self.effective_replicas(job)["Worker"]["replicas"]
        floor = max(1, int(elastic.get("minReplicas", 1)))
        if current - 1 < floor:
            return False
        status.setdefault("elasticReplicas", {})["Worker"] = current - 1
        status["lastElasticShrink"] = time.time()
        self.recorder.warning(
            job, "JobScaledDown",
            f"elastic: Worker[{index}] exit {rc}; world {current} -> {current - 1} (min {floor})",
        )
        return True

    def maybe_grow(self, job: Obj, status: dict):
        """Elastic scale-UP (SURVEY.md §5 failure row: ElasticPolicy + HPA):
        after a cooldown since the last shrink, re-expand one worker at a
        time back toward the spec count (capped by maxReplicas) — the
        simulator's stand-in for HPA-driven growth when capacity returns."""
        elastic = job["spec"].get("elasticPolicy") or {}
        shrunk = (status.get("elasticReplicas") or {}).get("Worker")
        # growth is opt-in (upstream: HPA attached to the elastic job)
        if not elastic.get("scaleUp") or shrunk is None:
            return None
        desired = job["spec"]["replicaSpecs"]["Worker"].get("replicas", 1)
        ceiling = min(desired, int(elastic.get("maxReplicas", desired)))
        if shrunk >= ceiling:
            return None
        cooldown = float(elastic.get("scaleUpCooldownSeconds", 1.0))
        since = time.time() - float(status.get("lastElasticShrink", 0))
        if since < cooldown:
            return Result(requeue_after=cooldown - since + 0.05)
        grown = shrunk + 1
        if grown >= ceiling and ceiling == desired:
            # fully recovered: drop the override entirely
            status.pop("elasticReplicas", None)
        else:
            # maxReplicas < spec count: the override must PERSIST at the
            # ceiling or effective_replicas would jump back to the spec count
            status["elasticReplicas"]["Worker"] = min(grown, ceiling)
        status["lastElasticShrink"] = time.time()  # pace successive grows
        self.recorder.normal(
            job, "JobScaledUp", f"elastic: world {shrunk} -> {grown} (ceiling {ceiling})"
        )
        return Result(requeue_after=0.05)


class MPIJobController(JobController):
    """MPIJob: launcher-runs-mpirun semantics.

    Upstream (SURVEY.md §2a MPIJob row): the controller renders a hostfile
    ConfigMap mounted into the Launcher pod; the launcher execs ``mpirun``
    against the Workers; job success is launcher success.  Here the hostfile
    ConfigMap is a real object the kubelet renders to a file under
    ``POD_VOLUME_ROOT`` (referenced via k8s ``$(VAR)`` env expansion), and
    the ip:port dial list for the simulator's transport shim rides MPI_HOSTS.
    """

    kind = "MPIJob"

    HOSTFILE_MOUNT = "/etc/mpi"

    def num_ports(self, total: int) -> int:
        return total

    def _hostfile_name(self, job: Obj) -> str:
        return f"{job['metadata']['name']}-hostfile"

    def prepare(self, job: Obj, replicas: dict) -> None:
        """Ensure the hostfile ConfigMap (upstream: one per MPIJob)."""
        name = job["metadata"]["name"]
        n_workers = replicas.get("Worker", {}).get("replicas", 0)
        slots = int((job["spec"].get("mpiImplementation") or {}).get("slotsPerWorker", 1)) \
            if isinstance(job["spec"].get("mpiImplementation"), dict) else \
            int(job["spec"].get("slotsPerWorker", 1))
        hostfile = "\n".join(
            f"{self.pod_name(job, 'Worker', i)} slots={slots}" for i in range(n_workers)
        )
        ns = job["metadata"].get("namespace", "default")
        existing = self.api.try_get("ConfigMap", self._hostfile_name(job), ns)
        if existing is None:
            try:
                self.api.create({
                    "apiVersion": "v1",
                    "kind": "ConfigMap",
                    "metadata": {
                        "name": self._hostfile_name(job),
                        "namespace": ns,
                        "ownerReferences": [owner_reference(job)],
                    },
                    "data": {"hostfile": hostfile},
                })
            except AlreadyExists:
                pass
        elif existing.get("data", {}).get("hostfile") != hostfile:
            # worker count changed (scale): re-render, don't serve stale hosts
            existing["data"] = {"hostfile": hostfile}
            self.api.update(existing)

    def mutate_pod(self, pod: Obj, job: Obj, rtype: str, index: int) -> None:
        if rtype != "Launcher":
            return
        pod["spec"].setdefault("volumes", []).append(
            {"name": "mpi-hostfile", "configMap": {"name": self._hostfile_name(job)}}
        )
        c = pod["spec"]["containers"][0]
        c.setdefault("volumeMounts", []).append(
            {"name": "mpi-hostfile", "mountPath": self.HOSTFILE_MOUNT}
        )

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        ports = self.ports_of(job)
        n_workers = replicas.get("Worker", {}).get("replicas", 0)
        hosts = [f"{_host(job, 'Worker', i)}:{ports[i]}" for i in range(n_workers)]
        env = {
            "MPI_HOSTS": ",".join(hosts),
            "MPI_NUM_WORKERS": str(n_workers),
        }
        if rtype == "Launcher":
            # k8s dependent-env expansion: the kubelet substitutes $(...)
            hostfile = f"$(POD_VOLUME_ROOT){self.HOSTFILE_MOUNT}/hostfile"
            env["OMPI_MCA_orte_default_hostfile"] = hostfile
            env["MPI_HOSTFILE"] = hostfile
        if rtype == "Worker":
            env["MPI_WORKER_ID"] = str(index)
            env["MPI_WORKER_PORT"] = str(ports[index])
        return env


class MXJobController(JobController):
    """MXJob: DMLC parameter-server rendezvous (scheduler/server/worker)."""

    kind = "MXJob"

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        ports = self.ports_of(job)
        env = {
            "DMLC_PS_ROOT_URI": _host(job, "Scheduler", 0),
            "DMLC_PS_ROOT_PORT": str(ports[0]),
            "DMLC_NUM_SERVER": str(replicas.get("Server", {}).get("replicas", 0)),
            "DMLC_NUM_WORKER": str(replicas.get("Worker", {}).get("replicas", 0)),
            "DMLC_ROLE": rtype.lower(),
        }
        if rtype == "Worker":
            env["DMLC_WORKER_ID"] = str(index)
        return env


class PaddleJobController(JobController):
    """PaddleJob: collective-mode trainer endpoints rendezvous."""

    kind = "PaddleJob"

    def num_ports(self, total: int) -> int:
        return total

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        ports = self.ports_of(job)
        has_master = "Master" in replicas
        n_workers = replicas.get("Worker", {}).get("replicas", 0)
        endpoints = [f"{_host(job, 'Worker', i)}:{ports[i]}" for i in range(n_workers)]
        rank = 0 if rtype == "Master" else index
        env = {
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_TRAINERS_NUM": str(n_workers),
            "PADDLE_TRAINER_ID": str(rank),
            "TRAINING_ROLE": "TRAINER",
        }
        if rtype == "Worker":
            env["PADDLE_CURRENT_ENDPOINT"] = endpoints[index]
        if has_master:
            env["PADDLE_MASTER"] = f"{_host(job, 'Master', 0)}:{ports[n_workers] if len(ports) > n_workers else ports[0]}"
        return env


class XGBoostJobController(JobController):
    """XGBoostJob: rabit/dmlc tracker env."""

    kind = "XGBoostJob"

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        ports = self.ports_of(job)
        world = sum(r["replicas"] for r in replicas.values())
        rank = 0 if rtype == "Master" else index + (1 if "Master" in replicas else 0)
        return {
            "DMLC_TRACKER_URI": _host(job, "Master", 0),
            "DMLC_TRACKER_PORT": str(ports[0]),
            "DMLC_NUM_WORKER": str(world),
            "DMLC_TASK_ID": str(rank),
        }


ALL_CONTROLLERS = (
    TPUJobController,
    JAXJobController,
    TFJobController,
    PyTorchJobController,
    MPIJobController,
    MXJobController,
    PaddleJobController,
    XGBoostJobController,
)


def install(api: APIServer, manager) -> list[JobController]:
    """Register CRDs and attach all training controllers to a Manager."""
    from . import api as tapi

    tapi.register(api)
    out = []
    for cls in ALL_CONTROLLERS:
        ctrl = cls(api)
        manager.add(ctrl, owns=("Pod",))
        out.append(ctrl)
    return out
