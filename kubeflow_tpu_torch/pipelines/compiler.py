"""Pipeline compiler: traced DSL → deterministic IR JSON.

A copy of ``kubeflow_tpu/pipelines/compiler.py`` over the port's ``dsl``:
the same ``IR_SCHEMA``, the same loop expansion, conditions, exit handlers
and dependency derivation, the same refusals with the same messages, and
byte-identical JSON for the same pipeline (``compile_to_json``).  Either
package's control plane takes the resulting IR dict as it is
(``PipelineService.create_run`` and ``Client.create_run_from_pipeline_func``
accept a dict).

Compile steps:
  1. trace the pipeline function (dsl.Pipeline.trace);
  2. expand ``ParallelFor`` groups — clone the sub-DAG per item, substituting
     ``LoopItem`` references with constants and remapping intra-loop data
     dependencies (nested loops expand recursively, outermost first);
  3. attach runtime conditions (enclosing ``dsl.Condition`` expressions) and
     derive ``dependentTasks`` = explicit ``.after`` + data deps + tasks
     referenced by conditions;
  4. emit components (deduped per component) + executors (embedded function
     source) + the root DAG.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Optional

from . import dsl
from .dsl import (
    Collected,
    ConditionExpr,
    LoopItem,
    LoopItemField,
    Pipeline,
    PipelineParam,
    Task,
    TaskOutput,
    _Group,
)

IR_SCHEMA = "kubeflow-tpu-pipelines/v1"


class CompileError(Exception):
    pass


# ------------------------------------------------------------ loop expansion


def _substitute(value: Any, gid: int, item: Any, clone_map: dict) -> Any:
    """Replace loop refs of group `gid` with `item`, remap cloned task refs."""
    if isinstance(value, LoopItem) and value.group_id == gid:
        return item
    if isinstance(value, LoopItemField) and value.group_id == gid:
        if not isinstance(item, dict) or value.key not in item:
            raise CompileError(f"ParallelFor item {item!r} has no field {value.key!r}")
        return item[value.key]
    if isinstance(value, TaskOutput) and id(value.task) in clone_map:
        return TaskOutput(clone_map[id(value.task)], value.name, value.is_artifact, value.type)
    if isinstance(value, ConditionExpr):
        return ConditionExpr(
            value.op,
            _substitute(value.left, gid, item, clone_map),
            _substitute(value.right, gid, item, clone_map),
        )
    return value


def _clone_task(t: Task, suffix: str, gid: int, item: Any, clone_map: dict) -> Task:
    c = Task(
        f"{t.name}{suffix}",
        t.component,
        {k: _substitute(v, gid, item, clone_map) for k, v in t.inputs.items()},
        tuple(
            _Group(g.kind, g.group_id, condition=_substitute(g.condition, gid, item, clone_map))
            if g.kind == "condition"
            else g
            for g in t.group_path
            if not (g.kind == "loop" and g.group_id == gid)
        ),
    )
    c.display_name = t.display_name if t.display_name != t.name else c.name
    c.resources = dict(t.resources)
    c.tpu = copy.deepcopy(t.tpu)
    c.enable_caching = t.enable_caching
    c.retries = t.retries
    c.dependencies = [
        clone_map.get(id(d), d) for d in t.dependencies
    ]
    return c


def _expand_loops(tasks: list[Task]) -> list[Task]:
    """Expand the first (outermost) STATIC loop group found; recurse until
    none left.  Dynamic groups (items_from) are left in place — the workflow
    controller expands them at runtime."""
    loop: Optional[_Group] = None
    for t in tasks:
        for g in t.group_path:
            if g.kind == "loop" and g.items_from is None:
                loop = g if loop is None or g.group_id < loop.group_id else loop
                break  # outermost in this task's path
    if loop is None:
        return tasks
    inside = [t for t in tasks if any(g is loop for g in t.group_path)]
    inside_ids = {id(t) for t in inside}
    out: list[Task] = []
    clones_by_orig: dict[int, list[Task]] = {id(t): [] for t in inside}
    for t in tasks:
        if id(t) not in inside_ids:
            out.append(t)
            continue
        for i, item in enumerate(loop.items or []):
            # map of already-cloned iteration-i tasks, for ref remapping
            clone_map = {
                oid: clones[i]
                for oid, clones in clones_by_orig.items()
                if len(clones) > i
            }
            c = _clone_task(t, f"-it{i}", loop.group_id, item, clone_map)
            clones_by_orig[id(t)].append(c)
            out.append(c)
    # references from OUTSIDE the loop to a task inside it are ambiguous —
    # catch data inputs, explicit .after() deps, and Condition references
    def _check_fanin(t: Task, ref_name: str) -> None:
        raise CompileError(
            f"task {t.name!r} references {ref_name!r} inside a ParallelFor "
            "from outside the loop; fan-in is not supported"
        )

    for t in out:
        for v in t.inputs.values():
            if isinstance(v, TaskOutput) and id(v.task) in inside_ids:
                _check_fanin(t, v.task.name)
        for d in t.dependencies:
            if id(d) in inside_ids:
                _check_fanin(t, d.name)
        for g in t.group_path:
            if g.kind == "condition" and g.condition is not None:
                for rt in g.condition.referenced_tasks():
                    if id(rt) in inside_ids:
                        _check_fanin(t, rt.name)
    return _expand_loops(out)


# -------------------------------------------------------------- IR emission


def _param_ref(value: Any, dynamic_gids: frozenset = frozenset()) -> dict:
    if isinstance(value, PipelineParam):
        return {"componentInputParameter": value.name}
    if isinstance(value, TaskOutput):
        if value.is_artifact:
            raise CompileError(f"artifact output {value.name!r} passed to a parameter input")
        return {
            "taskOutputParameter": {"producerTask": value.task.name, "outputParameterKey": value.name}
        }
    if isinstance(value, Collected):
        return {"collectedOutput": {
            "producerTask": value.source.task.name,
            "outputParameterKey": value.source.name,
        }}
    if isinstance(value, LoopItem):
        if value.group_id in dynamic_gids:
            return {"loopItem": {"groupId": value.group_id}}
        raise CompileError("loop item escaped expansion (used outside its ParallelFor?)")
    if isinstance(value, LoopItemField):
        if value.group_id in dynamic_gids:
            return {"loopItem": {"groupId": value.group_id, "field": value.key}}
        raise CompileError("loop item escaped expansion (used outside its ParallelFor?)")
    return {"constant": value}


def _expr_ir(e: Any, dynamic_gids: frozenset = frozenset()) -> Any:
    if isinstance(e, ConditionExpr):
        return {"op": e.op, "left": _expr_ir(e.left, dynamic_gids),
                "right": _expr_ir(e.right, dynamic_gids)}
    return _param_ref(e, dynamic_gids)


class Compiler:
    def compile(self, pipeline: Pipeline, output_path: Optional[str] = None) -> dict:
        if not isinstance(pipeline, Pipeline):
            raise TypeError("Compiler.compile takes a @dsl.pipeline-decorated function")
        ctx = pipeline.trace()
        tasks = _expand_loops(ctx.tasks)

        names = [t.name for t in tasks]
        if len(set(names)) != len(names):
            raise CompileError(f"duplicate task names after expansion: {sorted(names)}")

        # dynamic ParallelFor groups survive expansion: validate structure
        # and collect their gids for loopItem IR markers
        dyn_groups: dict[int, _Group] = {}
        for t in tasks:
            dyn_in_path = [g for g in t.group_path
                           if g.kind == "loop" and g.items_from is not None]
            for g in dyn_in_path:
                dyn_groups[g.group_id] = g
            if len(dyn_in_path) > 1:
                raise CompileError(
                    f"task {t.name!r}: dynamic ParallelFors cannot nest "
                    "inside each other (one runtime iterator per task)")
        import re as _re

        for g in dyn_groups.values():
            inside_ids = {id(t) for t in tasks
                          if any(x is g for x in t.group_path)}
            if id(g.items_from.task) in inside_ids:
                raise CompileError(
                    f"dynamic ParallelFor iterates the output of "
                    f"{g.items_from.task.name!r}, which is inside the loop")
            for g2 in dyn_groups.values():
                if g2 is not g and any(x is g2 for x in
                                       g.items_from.task.group_path):
                    raise CompileError(
                        f"dynamic ParallelFor iterates the output of "
                        f"{g.items_from.task.name!r}, which is inside another "
                        "dynamic ParallelFor; fan-in is not supported")
            if g.items_from.task.name not in names:
                # e.g. the producer sat inside an enclosing STATIC loop and
                # was cloned away — the runtime reference would dangle
                raise CompileError(
                    f"dynamic ParallelFor source {g.items_from.task.name!r} "
                    "does not survive loop expansion (was it defined inside "
                    "an enclosing ParallelFor?)")
            for t in tasks:
                if id(t) in inside_ids:
                    continue
                # DATA fan-in (outputs/conditions) is ambiguous — which
                # iteration? — and rejected, matching the static expansion;
                # dsl.Collected is the sanctioned fan-in and plain .after()
                # CONTROL deps gate on the loop's virtual node.
                refs = [v.task.name for v in t.inputs.values()
                        if isinstance(v, TaskOutput) and id(v.task) in inside_ids]
                for gp in t.group_path:
                    if gp.kind == "condition" and gp.condition is not None:
                        refs += [rt.name for rt in gp.condition.referenced_tasks()
                                 if id(rt) in inside_ids]
                if refs:
                    raise CompileError(
                        f"task {t.name!r} references {refs[0]!r} inside a "
                        "dynamic ParallelFor from outside the loop; fan-in "
                        "is not supported (dsl.Collected collects outputs)")
        for t in tasks:
            if not any(g.kind == "loop" and g.items_from is not None
                       for g in t.group_path):
                continue
            # runtime children are named {task}-it{K}: a REAL task with that
            # literal name would alias the child's status-node entry
            pat = _re.compile(_re.escape(t.name) + r"-it\d+$")
            clash = [n for n in names if n != t.name and pat.fullmatch(n)]
            if clash:
                raise CompileError(
                    f"task name {clash[0]!r} collides with runtime children "
                    f"of the dynamic ParallelFor task {t.name!r}")
        def _exprs_contain_collected(e) -> bool:
            if isinstance(e, Collected):
                return True
            if isinstance(e, ConditionExpr):
                return (_exprs_contain_collected(e.left)
                        or _exprs_contain_collected(e.right))
            return False

        for t in tasks:
            for g in t.group_path:
                if (g.kind == "condition" and g.condition is not None
                        and _exprs_contain_collected(g.condition)):
                    # referenced_tasks() doesn't see through Collected, so
                    # the condition would evaluate BEFORE the loop expands
                    # (against an empty list) — reject rather than misfire
                    raise CompileError(
                        f"task {t.name!r}: dsl.Collected cannot be used in a "
                        "dsl.Condition — collect into a task input and gate "
                        "on that task's output instead")
            for pname, value in t.inputs.items():
                if not isinstance(value, Collected):
                    continue
                src = value.source.task
                src_dyn = [g for g in src.group_path
                           if g.kind == "loop" and g.items_from is not None]
                if not src_dyn:
                    raise CompileError(
                        f"task {t.name!r} input {pname!r}: dsl.Collected "
                        f"source {src.name!r} is not inside a dynamic "
                        "ParallelFor — use the output directly")
                if any(g is src_dyn[-1] for g in t.group_path):
                    raise CompileError(
                        f"task {t.name!r} input {pname!r}: dsl.Collected "
                        "must be consumed OUTSIDE the loop it collects "
                        "(inside it, use the loop item / task output)")
                if src.name not in names:
                    # cloned away by an enclosing static loop: the emitted
                    # producerTask would dangle and the run would hang
                    raise CompileError(
                        f"task {t.name!r} input {pname!r}: dsl.Collected "
                        f"source {src.name!r} does not survive loop "
                        "expansion (is it inside an enclosing static "
                        "ParallelFor?)")

        # ExitHandler wiring: every task inside an exit group becomes a
        # dependency of that group's cleanup task, which is flagged so the
        # workflow runs it on ANY terminal dep phase (not just success)
        exit_deps: dict = {}  # exit Task -> set of guarded task names
        for t in tasks:
            for g in t.group_path:
                if g.kind == "exit":
                    if t is g.exit_task:
                        raise CompileError(
                            f"exit task {t.name!r} cannot be created inside its "
                            "own ExitHandler block")
                    exit_deps.setdefault(g.exit_task, set()).add(t.name)
        for et in exit_deps:
            if et not in tasks:
                raise CompileError(
                    f"exit task {et.name!r} is not part of this pipeline")
            # the cleanup runs even when producers FAILED, so a TaskOutput
            # input could be unresolvable at execution time — forbid them
            # (upstream likewise restricts exit-handler inputs)
            for pname, value in et.inputs.items():
                if isinstance(value, (TaskOutput, Collected)):
                    raise CompileError(
                        f"exit task {et.name!r} input {pname!r} references a task "
                        "output; exit handlers run after failures too, so they "
                        "may only take constants or pipeline parameters")
            # same hazard through an enclosing dsl.Condition: an expression
            # over a failed task's output would be unresolvable at cleanup
            for g in et.group_path:
                if g.kind == "condition" and g.condition is not None \
                        and g.condition.referenced_tasks():
                    raise CompileError(
                        f"exit task {et.name!r} sits inside a dsl.Condition that "
                        "references a task output; exit handlers run after "
                        "failures, so such a condition may be unresolvable — "
                        "gate on pipeline parameters only")

        components: dict = {}
        executors: dict = {}
        dag: dict = {}
        for t in tasks:
            spec = t.component.spec
            comp_key = f"comp-{spec.name}"
            if comp_key not in components:
                components[comp_key] = {
                    "executorLabel": f"exec-{spec.name}",
                    "inputDefinitions": {
                        "parameters": {
                            p: {"parameterType": d["type"]} for p, d in spec.input_params.items()
                        },
                        "artifacts": {
                            a: {"schemaTitle": s} for a, s in spec.input_artifacts.items()
                        },
                    },
                    "outputDefinitions": {
                        "parameters": {p: {"parameterType": ty} for p, ty in spec.output_params.items()},
                        "artifacts": {a: {"schemaTitle": s} for a, s in spec.output_artifacts.items()},
                    },
                }
                executors[f"exec-{spec.name}"] = {
                    "python": {
                        "functionName": spec.function_name,
                        "source": spec.source,
                        "defaults": dict(sorted(spec.defaults.items())),
                    }
                }
            deps = {d.name for d in t.dependencies}
            # loopItem markers are legal only for dynamic groups THIS task
            # sits in — an item that escaped its with-block must fail the
            # compile exactly like the static path does
            task_dyn_gids = frozenset(
                g.group_id for g in t.group_path
                if g.kind == "loop" and g.items_from is not None)
            params_ir: dict = {}
            artifacts_ir: dict = {}
            for pname, value in sorted(t.inputs.items()):
                if pname in spec.input_artifacts:
                    if not (isinstance(value, TaskOutput) and value.is_artifact):
                        raise CompileError(
                            f"task {t.name!r} input {pname!r} expects an artifact "
                            f"(another task's Output[...]), got {value!r}"
                        )
                    artifacts_ir[pname] = {
                        "taskOutputArtifact": {
                            "producerTask": value.task.name,
                            "outputArtifactKey": value.name,
                        }
                    }
                    deps.add(value.task.name)
                else:
                    params_ir[pname] = _param_ref(value, task_dyn_gids)
                    if isinstance(value, TaskOutput):
                        deps.add(value.task.name)
                    elif isinstance(value, Collected):
                        # gate on the loop's VIRTUAL node: all iterations
                        # terminal before the collection resolves
                        deps.add(value.source.task.name)
            conditions = []
            for g in t.group_path:
                if g.kind == "condition" and g.condition is not None:
                    conditions.append(_expr_ir(g.condition, task_dyn_gids))
                    for rt in g.condition.referenced_tasks():
                        deps.add(rt.name)
            iterator = None
            for g in t.group_path:
                if g.kind == "loop" and g.items_from is not None:
                    iterator = {"producerTask": g.items_from.task.name,
                                "outputParameterKey": g.items_from.name,
                                "groupId": g.group_id}
                    deps.add(g.items_from.task.name)
            if t in exit_deps:
                deps |= exit_deps[t]
            node: dict = {
                "componentRef": comp_key,
                "displayName": t.display_name,
                "dependentTasks": sorted(deps),
                "inputs": {"parameters": params_ir, "artifacts": artifacts_ir},
                "cachingOptions": {"enableCache": t.enable_caching},
            }
            if t in exit_deps:
                node["isExitHandler"] = True
            if conditions:
                node["conditions"] = conditions
            if iterator is not None:
                if t in exit_deps:
                    raise CompileError(
                        f"exit task {t.name!r} cannot sit inside a dynamic "
                        "ParallelFor (cleanup must run once, after the whole "
                        "fan-out — place the ExitHandler outside the loop)")
                node["iterator"] = iterator
            if t.retries:
                node["retries"] = t.retries
            if t.resources:
                node["resources"] = dict(sorted(t.resources.items()))
            if t.tpu:
                node["tpu"] = t.tpu
            dag[t.name] = node

        ir = {
            "schemaVersion": IR_SCHEMA,
            "pipelineInfo": {"name": pipeline.name, "description": pipeline.description},
            "root": {
                "inputDefinitions": {
                    "parameters": {
                        p: (
                            {"parameterType": ty, "defaultValue": pipeline.defaults[p]}
                            if p in pipeline.defaults
                            else {"parameterType": ty}
                        )
                        for p, ty in pipeline.params.items()
                    }
                },
                "dag": {"tasks": dag},
            },
            "components": components,
            "deploymentSpec": {"executors": executors},
        }
        if output_path:
            # tmp+os.replace: compiled IR is a durable artifact other
            # tooling loads (graftlint atomic-write)
            with open(output_path + ".tmp", "w") as f:
                json.dump(ir, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(output_path + ".tmp", output_path)
        return ir


def compile_to_json(pipeline: Pipeline) -> str:
    return json.dumps(Compiler().compile(pipeline), indent=2, sort_keys=True) + "\n"
