"""Pipelines DSL: ``@component`` + ``@pipeline`` with typed params/artifacts.

A copy of ``kubeflow_tpu/pipelines/dsl.py`` (the port imports nothing of the
JAX package): ``@component`` lightweight Python components whose source is
embedded in the compiled IR, ``@pipeline`` tracing, the artifact types,
``Input[...]``/``Output[...]``, ``Condition``, ``ParallelFor`` (static lists
expanded at compile time, a task output fanned out at run time),
``ExitHandler`` and ``Collected``.  The port's pipelines are built on it and
compiled by the port's ``compiler``; the IR is plain JSON, which the port's
control plane (``workflow``, ``service``, ``metadata``) runs, each step
exec'ing the component's source in its pod.
"""

from __future__ import annotations

import copy
import inspect
import textwrap
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

# --------------------------------------------------------------------- types

_PARAM_TYPES = {int: "Int", float: "Float", str: "String", bool: "Bool", dict: "Dict", list: "List"}


class Artifact:
    """A file-backed artifact with a URI, a local path, and metadata.

    Inside a component the launcher hands the function an instance whose
    ``.path`` is a real local file/dir path; metadata written here is
    persisted to the metadata store after the step.
    """

    schema_title = "system.Artifact"

    def __init__(self, name: str = "", uri: str = "", metadata: Optional[dict] = None):
        self.name = name
        self.uri = uri
        self.metadata = dict(metadata or {})
        self.path = ""  # set by the launcher to the local staging path

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}(name={self.name!r}, uri={self.uri!r})"


class Dataset(Artifact):
    schema_title = "system.Dataset"


class Model(Artifact):
    schema_title = "system.Model"


class Metrics(Artifact):
    schema_title = "system.Metrics"

    def log_metric(self, key: str, value: float) -> None:
        self.metadata[key] = float(value)


ARTIFACT_TYPES = {c.schema_title: c for c in (Artifact, Dataset, Model, Metrics)}


class _IOSpec:
    __slots__ = ("artifact_type",)

    def __init__(self, artifact_type: type):
        if not (isinstance(artifact_type, type) and issubclass(artifact_type, Artifact)):
            raise TypeError(f"Input[...]/Output[...] takes an Artifact subclass, got {artifact_type!r}")
        self.artifact_type = artifact_type


class _InputSpec(_IOSpec):
    pass


class _OutputSpec(_IOSpec):
    pass


class Input:
    """``Input[Dataset]`` annotation marker for input artifacts."""

    def __class_getitem__(cls, item: type) -> _InputSpec:
        return _InputSpec(item)


class Output:
    """``Output[Model]`` annotation marker for output artifacts."""

    def __class_getitem__(cls, item: type) -> _OutputSpec:
        return _OutputSpec(item)


# ---------------------------------------------------------------- references


class _Comparable:
    """Operator overloads building Condition expressions from references."""

    def _cmp(self, op: str, other: Any) -> "ConditionExpr":
        return ConditionExpr(op, self, other)

    def __eq__(self, other):  # type: ignore[override]
        return self._cmp("==", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._cmp("!=", other)

    def __lt__(self, other):
        return self._cmp("<", other)

    def __le__(self, other):
        return self._cmp("<=", other)

    def __gt__(self, other):
        return self._cmp(">", other)

    def __ge__(self, other):
        return self._cmp(">=", other)

    def __hash__(self):
        return id(self)


@dataclass(eq=False)
class PipelineParam(_Comparable):
    """Reference to a pipeline input parameter."""

    name: str
    type: str = "String"


@dataclass(eq=False)
class LoopItem(_Comparable):
    """Placeholder for the current item of a ParallelFor (compile-time expanded)."""

    group_id: int

    def __getitem__(self, key: str) -> "LoopItemField":
        return LoopItemField(self.group_id, key)


@dataclass(eq=False)
class LoopItemField(_Comparable):
    group_id: int
    key: str


@dataclass(eq=False)
class TaskOutput(_Comparable):
    """Reference to another task's output parameter or artifact."""

    task: "Task"
    name: str
    is_artifact: bool
    type: str = "String"


@dataclass(eq=False)
class Collected(_Comparable):
    """Fan-in over a dynamic ParallelFor: ``dsl.Collected(task.output)``
    consumed OUTSIDE the loop resolves at runtime to the list of every
    iteration's output, in item order (upstream KFP v2 ``dsl.Collected``).
    Parameter outputs only — collect an artifact by returning its path/
    content as a parameter."""

    source: TaskOutput

    def __post_init__(self):
        if not isinstance(self.source, TaskOutput):
            raise TypeError("dsl.Collected takes a task output "
                            "(e.g. Collected(task.output))")
        if self.source.is_artifact:
            raise TypeError(
                "dsl.Collected collects parameter outputs; return the "
                "artifact's content (or URI) as a parameter to collect it")


class ConditionExpr:
    """A binary comparison over references/constants, evaluated by the driver."""

    def __init__(self, op: str, left: Any, right: Any):
        self.op = op
        self.left = left
        self.right = right

    def referenced_tasks(self) -> list["Task"]:
        return [x.task for x in (self.left, self.right) if isinstance(x, TaskOutput)]


# -------------------------------------------------------------------- groups


@dataclass
class _Group:
    kind: str  # "root" | "condition" | "loop" | "exit"
    group_id: int
    condition: Optional[ConditionExpr] = None
    items: Optional[Union[list, TaskOutput]] = None
    loop_item: Optional[LoopItem] = None
    tasks: list["Task"] = field(default_factory=list)
    exit_task: Optional["Task"] = None  # kind == "exit": the cleanup task
    # dynamic ParallelFor: fan out at RUNTIME over a producer task's list
    # output (upstream KFP v2 `dsl.ParallelFor(task.output)`); the compiler
    # emits an `iterator` marker instead of cloning, and the workflow
    # controller expands when the producer completes
    items_from: Optional[TaskOutput] = None


class Condition:
    """``with dsl.Condition(task.output > 0.5):`` — runtime-gated sub-DAG."""

    def __init__(self, expr: ConditionExpr, name: str = ""):
        if not isinstance(expr, ConditionExpr):
            raise TypeError("dsl.Condition takes a comparison over a task output or pipeline param")
        self.expr = expr
        self.name = name

    def __enter__(self):
        ctx = _require_context("dsl.Condition")
        ctx.push_group(_Group("condition", ctx.next_group_id(), condition=self.expr))
        return self

    def __exit__(self, *exc):
        _require_context("dsl.Condition").pop_group()
        return False


class ExitHandler:
    """``with dsl.ExitHandler(cleanup_task):`` — the cleanup task runs once
    every task in the block reaches ANY terminal state, success or failure
    (upstream ``[U:pipelines/sdk/python/kfp/dsl]`` ExitHandler semantics; the
    workflow stays Running until the cleanup finishes, then reports the
    block's real outcome).  ``cleanup_task`` must be created BEFORE the
    ``with`` block and take only regular inputs."""

    def __init__(self, exit_task: "Task"):
        if not isinstance(exit_task, Task):
            raise TypeError("dsl.ExitHandler takes the cleanup Task "
                            "(create it before the with block)")
        self.exit_task = exit_task

    def __enter__(self):
        ctx = _require_context("dsl.ExitHandler")
        ctx.push_group(_Group("exit", ctx.next_group_id(), exit_task=self.exit_task))
        return self

    def __exit__(self, *exc):
        _require_context("dsl.ExitHandler").pop_group()
        return False


class ParallelFor:
    """``with dsl.ParallelFor(items) as item:`` — fan-out per item.

    A static list expands at compile time (cloned tasks); a task output
    (``dsl.ParallelFor(t.output)``) expands at RUNTIME once the producer
    finishes — the output must be a JSON list."""

    def __init__(self, items: Union[list, tuple, TaskOutput]):
        self.items: Optional[list] = None
        self.items_from: Optional[TaskOutput] = None
        if isinstance(items, TaskOutput):
            if items.is_artifact:
                raise TypeError(
                    "dynamic ParallelFor iterates a parameter output (a JSON "
                    "list), not an artifact — return the list from the "
                    "component instead"
                )
            self.items_from = items
        else:
            self.items = list(items)

    def __enter__(self) -> LoopItem:
        ctx = _require_context("dsl.ParallelFor")
        gid = ctx.next_group_id()
        g = _Group("loop", gid, items=self.items, loop_item=LoopItem(gid),
                   items_from=self.items_from)
        ctx.push_group(g)
        return g.loop_item

    def __exit__(self, *exc):
        _require_context("dsl.ParallelFor").pop_group()
        return False


# ----------------------------------------------------------------- component


@dataclass
class ComponentSpec:
    name: str
    source: str
    function_name: str
    input_params: dict  # name -> {"type": str, "default": present?}
    input_artifacts: dict  # name -> schema_title
    output_params: dict  # name -> type
    output_artifacts: dict  # name -> schema_title
    defaults: dict


class Component:
    """A Python-function component; calling it inside a pipeline adds a Task."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        self.name = name or fn.__name__.replace("_", "-")
        self.spec = self._introspect(fn)

    def _introspect(self, fn: Callable) -> ComponentSpec:
        # eval_str: modules with `from __future__ import annotations` deliver
        # annotations as strings; Input/Output markers must be real objects
        sig = inspect.signature(fn, eval_str=True)
        in_params: dict = {}
        in_artifacts: dict = {}
        out_params: dict = {}
        out_artifacts: dict = {}
        defaults: dict = {}
        for pname, p in sig.parameters.items():
            ann = p.annotation
            if isinstance(ann, _OutputSpec):
                out_artifacts[pname] = ann.artifact_type.schema_title
            elif isinstance(ann, _InputSpec):
                in_artifacts[pname] = ann.artifact_type.schema_title
            elif isinstance(ann, type) and issubclass(ann, Artifact):
                raise TypeError(
                    f"component {self.name!r} param {pname!r}: use Input[{ann.__name__}] "
                    f"or Output[{ann.__name__}], not the bare artifact type"
                )
            else:
                ptype = _PARAM_TYPES.get(ann, "String")
                in_params[pname] = {"type": ptype}
                if p.default is not inspect.Parameter.empty:
                    defaults[pname] = p.default
        ret = sig.return_annotation
        if ret is not inspect.Signature.empty and ret is not None:
            out_params["Output"] = _PARAM_TYPES.get(ret, "String")
        try:
            source = textwrap.dedent(inspect.getsource(fn))
        except (OSError, TypeError) as e:
            raise ValueError(
                f"component {self.name!r}: cannot extract source for the launcher ({e}); "
                "define components at module/function top level"
            ) from e
        # strip decorator lines so the source is a plain function definition
        lines = source.splitlines()
        start = next(i for i, ln in enumerate(lines) if ln.lstrip().startswith("def "))
        return ComponentSpec(
            name=self.name,
            source="\n".join(lines[start:]) + "\n",
            function_name=fn.__name__,
            input_params=in_params,
            input_artifacts=in_artifacts,
            output_params=out_params,
            output_artifacts=out_artifacts,
            defaults=defaults,
        )

    def __call__(self, **kwargs: Any) -> "Task":
        ctx = _current_context()
        if ctx is None:
            # outside a pipeline: run the function directly (unit-test ergonomics)
            return self.fn(**kwargs)
        return ctx.add_task(self, kwargs)


def component(fn: Optional[Callable] = None, *, name: Optional[str] = None):
    """Decorator: ``@dsl.component`` or ``@dsl.component(name=...)``."""
    if fn is None:
        return lambda f: Component(f, name=name)
    return Component(fn)


# ---------------------------------------------------------------------- task


class _TaskOutputs:
    def __init__(self, task: "Task"):
        self._task = task

    def __getitem__(self, name: str) -> TaskOutput:
        spec = self._task.component.spec
        if name in spec.output_artifacts:
            return TaskOutput(self._task, name, is_artifact=True, type=spec.output_artifacts[name])
        if name in spec.output_params:
            return TaskOutput(self._task, name, is_artifact=False, type=spec.output_params[name])
        raise KeyError(
            f"component {spec.name!r} has no output {name!r} "
            f"(params: {sorted(spec.output_params)}, artifacts: {sorted(spec.output_artifacts)})"
        )


class Task:
    """One node of the pipeline DAG."""

    def __init__(self, name: str, component_: Component, inputs: dict, group_path: tuple):
        self.name = name
        self.component = component_
        self.inputs = inputs  # pname -> constant | PipelineParam | TaskOutput | LoopItem(Field)
        self.group_path = group_path  # enclosing Condition/ParallelFor groups, outermost first
        self.dependencies: list[Task] = []
        self.display_name = name
        self.resources: dict = {}
        self.tpu: Optional[dict] = None
        self.enable_caching = True
        self.retries = 0
        self.outputs = _TaskOutputs(self)

    @property
    def output(self) -> TaskOutput:
        spec = self.component.spec
        if len(spec.output_params) == 1:
            return self.outputs[next(iter(spec.output_params))]
        if not spec.output_params and len(spec.output_artifacts) == 1:
            return self.outputs[next(iter(spec.output_artifacts))]
        raise AttributeError(
            f"task {self.name!r} has multiple outputs; use .outputs['name']"
        )

    # -------- fluent config (subset of upstream PipelineTask methods) --------

    def after(self, *tasks: "Task") -> "Task":
        self.dependencies.extend(tasks)
        return self

    def set_display_name(self, name: str) -> "Task":
        self.display_name = name
        return self

    def set_cpu_limit(self, cpu: str) -> "Task":
        self.resources["cpu"] = cpu
        return self

    def set_memory_limit(self, memory: str) -> "Task":
        self.resources["memory"] = memory
        return self

    def set_tpu(self, accelerator: str, chips: int = 0) -> "Task":
        """Request a TPU slice for this step, e.g. ``set_tpu("v5e-8")``.

        The compiled node asks the topology scheduler for a ``google.com/tpu``
        placement; chips defaults to the count encoded in the name (the
        ``-N`` suffix, or an ``AxB`` topology tail).  Validated here so a bad
        accelerator string fails at pipeline-definition time, not inside the
        workflow controller.
        """
        if not chips:
            tail = accelerator.rsplit("-", 1)[-1]
            try:
                if "x" in tail:
                    chips = 1
                    for part in tail.split("x"):
                        chips *= int(part)
                else:
                    chips = int(tail)
            except ValueError:
                raise ValueError(
                    f"set_tpu: cannot infer chip count from {accelerator!r}; "
                    "use e.g. 'v5e-8' / 'v5e-2x4' or pass chips= explicitly"
                ) from None
        self.tpu = {"accelerator": accelerator, "chips": int(chips)}
        return self

    def set_caching_options(self, enable: bool) -> "Task":
        self.enable_caching = enable
        return self

    def set_retry(self, num_retries: int) -> "Task":
        self.retries = int(num_retries)
        return self


# ------------------------------------------------------------------ pipeline


class _BuildContext:
    def __init__(self):
        self.root = _Group("root", 0)
        self._stack = [self.root]
        self.tasks: list[Task] = []
        self._names: dict[str, int] = {}
        self._gid = 0

    def next_group_id(self) -> int:
        self._gid += 1
        return self._gid

    def push_group(self, g: _Group) -> None:
        self._stack.append(g)

    def pop_group(self) -> None:
        self._stack.pop()

    def add_task(self, component_: Component, kwargs: dict) -> Task:
        spec = component_.spec
        known = set(spec.input_params) | set(spec.input_artifacts)
        unknown = set(kwargs) - known
        if unknown:
            raise TypeError(f"component {spec.name!r}: unknown inputs {sorted(unknown)}")
        missing = [
            p for p in spec.input_params
            if p not in kwargs and p not in spec.defaults
        ] + [a for a in spec.input_artifacts if a not in kwargs]
        if missing:
            raise TypeError(f"component {spec.name!r}: missing inputs {missing}")
        n = self._names.get(spec.name, 0) + 1
        self._names[spec.name] = n
        name = spec.name if n == 1 else f"{spec.name}-{n}"
        task = Task(name, component_, dict(kwargs), tuple(self._stack[1:]))
        self._stack[-1].tasks.append(task)
        self.tasks.append(task)
        return task


_ctx_stack: list[_BuildContext] = []


def _current_context() -> Optional[_BuildContext]:
    return _ctx_stack[-1] if _ctx_stack else None


def _require_context(what: str) -> _BuildContext:
    ctx = _current_context()
    if ctx is None:
        raise RuntimeError(f"{what} used outside a @dsl.pipeline function")
    return ctx


class Pipeline:
    """A traced pipeline definition (compile with compiler.Compiler)."""

    def __init__(self, fn: Callable, name: Optional[str] = None, description: str = ""):
        self.fn = fn
        self.name = name or fn.__name__.replace("_", "-")
        self.description = description
        sig = inspect.signature(fn)
        self.params: dict = {}
        self.defaults: dict = {}
        for pname, p in sig.parameters.items():
            self.params[pname] = _PARAM_TYPES.get(p.annotation, "String")
            if p.default is not inspect.Parameter.empty:
                self.defaults[pname] = p.default

    def trace(self) -> _BuildContext:
        ctx = _BuildContext()
        _ctx_stack.append(ctx)
        try:
            self.fn(**{p: PipelineParam(p, t) for p, t in self.params.items()})
        finally:
            _ctx_stack.pop()
        return ctx


def pipeline(fn: Optional[Callable] = None, *, name: Optional[str] = None, description: str = ""):
    """Decorator: ``@dsl.pipeline`` or ``@dsl.pipeline(name=..., description=...)``."""
    if fn is None:
        return lambda f: Pipeline(f, name=name, description=description)
    return Pipeline(fn)
