"""PipelineService: the KFP API-server equivalent.

A copy of ``kubeflow_tpu/pipelines/service.py``.

Upstream analogue (UNVERIFIED, SURVEY.md §2/§3.5): the KFP API server keeps
pipelines / experiments / runs in MySQL, submits Argo Workflows, and a
separate persistence agent reports Workflow state back via ReportWorkflow.
Here the records persist in the native metadata store (contexts — the
"MySQL is native, SQLite-equiv acceptable" rule of SURVEY §2b), runs are
Workflow CRs, ``report_workflow`` is the ReportWorkflow RPC stand-in, and
the watch-driven agent lives in pipelines/persistence.py.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Optional, Union

from ..core.api import APIServer, Obj
from . import api as papi
from . import metadata as md
from .artifacts import ObjectStore
from .compiler import Compiler
from .dsl import Pipeline

PIPELINE_CTX = "kfp.pipeline"
EXPERIMENT_CTX = "kfp.experiment"
RUN_CTX = "kfp.run"


class PipelineService:
    def __init__(self, api: APIServer, metadata_store: md.MetadataStore, store: ObjectStore):
        self.api = api
        self.metadata = metadata_store
        self.store = store

    # -------------------------------------------------------------- pipelines

    def upload_pipeline(
        self, pipeline: Union[Pipeline, dict], name: Optional[str] = None, description: str = ""
    ) -> str:
        """Register a pipeline (compiled on upload if given as a dsl.Pipeline)."""
        ir = Compiler().compile(pipeline) if isinstance(pipeline, Pipeline) else pipeline
        pname = name or ir["pipelineInfo"]["name"]
        existing = self.metadata.get_context_by_name(PIPELINE_CTX, pname)
        versions = existing.properties.get("versions", []) if existing else []
        uri = self.store.uri("mlpipeline", f"pipelines/{pname}/v{len(versions) + 1}.json")
        self.store.put_bytes(uri, json.dumps(ir, sort_keys=True).encode())
        versions.append({"version": len(versions) + 1, "uri": uri, "createdAt": time.time()})
        self.metadata.put_context(
            PIPELINE_CTX,
            pname,
            {"description": description or ir["pipelineInfo"].get("description", ""), "versions": versions},
        )
        return pname

    def get_pipeline(self, name: str, version: Optional[int] = None) -> dict:
        ctx = self.metadata.get_context_by_name(PIPELINE_CTX, name)
        if ctx is None:
            raise KeyError(f"pipeline {name!r} not found")
        versions = ctx.properties["versions"]
        if version is None:
            v = versions[-1]
        else:
            if not 1 <= version <= len(versions):
                raise KeyError(
                    f"pipeline {name!r} has versions 1..{len(versions)}, not {version}"
                )
            v = versions[version - 1]
        return json.loads(self.store.get_bytes(v["uri"]).decode())

    def list_pipelines(self) -> list[str]:
        return sorted(c.name for c in self._contexts(PIPELINE_CTX))

    def _contexts(self, ctx_type: str) -> list:
        # "__registry__" was internal bookkeeping in stores written before the
        # contexts_by_type index existed; never surface it as a record
        return [c for c in self.metadata.contexts_by_type(ctx_type) if c.name != "__registry__"]

    # ------------------------------------------------------------ experiments

    def create_experiment(self, name: str, description: str = "") -> str:
        self.metadata.put_context(EXPERIMENT_CTX, name, {"description": description, "createdAt": time.time()})
        return name

    def list_experiments(self) -> list[str]:
        return sorted(c.name for c in self._contexts(EXPERIMENT_CTX))

    # ------------------------------------------------------------------- runs

    def create_run(
        self,
        pipeline: Union[Pipeline, dict, str],
        arguments: Optional[dict] = None,
        run_name: Optional[str] = None,
        experiment: Optional[str] = None,
        namespace: str = "default",
    ) -> str:
        if isinstance(pipeline, str):
            ir = self.get_pipeline(pipeline)
        elif isinstance(pipeline, Pipeline):
            ir = Compiler().compile(pipeline)
        else:
            ir = pipeline
        run_id = run_name or f"run-{uuid.uuid4().hex[:8]}"
        wf = papi.workflow(run_id, ir, arguments=arguments, namespace=namespace, labels={papi.LABEL_RUN: run_id})
        self.api.create(wf)
        self.metadata.put_context(
            RUN_CTX,
            run_id,
            {
                "pipeline": ir["pipelineInfo"]["name"],
                "experiment": experiment or "Default",
                "namespace": namespace,
                "arguments": arguments or {},
                "createdAt": time.time(),
                "phase": papi.PENDING,
            },
        )
        return run_id

    def get_run(self, run_id: str) -> dict:
        ctx = self.metadata.get_context_by_name(RUN_CTX, run_id)
        if ctx is None:
            raise KeyError(f"run {run_id!r} not found")
        rec = dict(ctx.properties)
        wf = self.api.try_get("Workflow", run_id, rec.get("namespace", "default"))
        if wf is not None:
            rec["phase"] = wf.get("status", {}).get("phase", papi.PENDING)
            rec["nodes"] = wf.get("status", {}).get("nodes", {})
        return rec

    def list_runs(self, experiment: Optional[str] = None) -> list[dict]:
        out = []
        for c in self._contexts(RUN_CTX):
            if experiment and c.properties.get("experiment") != experiment:
                continue
            out.append({"run": c.name, **c.properties})
        return sorted(out, key=lambda r: r.get("createdAt", 0))

    # --------------------------------------------------- ReportWorkflow RPC

    def report_workflow(self, wf: dict) -> bool:
        """Fold one Workflow's state into its run record — the stand-in for
        upstream's ReportWorkflow RPC, called by the persistence agent
        (pipelines/persistence.py) on every watched Workflow change."""
        run_id = wf.get("metadata", {}).get("name")
        ctx = self.metadata.get_context_by_name(RUN_CTX, run_id)
        if ctx is None:
            return False  # a Workflow not created through create_run
        props = dict(ctx.properties)
        if props.get("phase") in papi.WORKFLOW_TERMINAL:
            return False
        phase = wf.get("status", {}).get("phase")
        if not phase or phase == props.get("phase"):
            return False
        props["phase"] = phase
        if phase in papi.WORKFLOW_TERMINAL:
            props["finishedAt"] = wf["status"].get("finishedAt")
        self.metadata.put_context(RUN_CTX, run_id, props)
        return True
