"""Central-dashboard web shell: server-rendered HTML over the data layer.

Upstream analogue (UNVERIFIED, SURVEY.md §2a): the centraldashboard shell +
katib-ui.  Upstream ships a Node/Polymer SPA; pixels are out of scope
(SURVEY.md §7), but the SHELL capability — a browser hitting one port and
seeing namespaces, workloads, quota and experiment results, gated by the
same RBAC as the API — is platform surface, so this serves it as plain
server-rendered HTML from the existing data layers (`Dashboard`,
`KatibService`) with zero frontend toolchain.

Identity arrives in the ``kubeflow-userid`` header, exactly where upstream's
Istio ingress puts it; every page authorizes through ProfileRBACAuthorizer,
so a stranger's request 403s rather than rendering an empty shell.

The port's copy of ``kubeflow_tpu/platform/webui.py``.  The accelerator is
the ``nvidia.com/gpu`` card; renamed for it, each beside the reference's:
  * the overview's "GPUs" (a namespace card's and the totals' count of
    requested cards, ``Dashboard.overview``'s ``gpus_requested``) — "TPU
    chips" (``tpu_chips_requested``);
  * the spawner form's ``gpus`` field (from the spawner config's ``gpus``)
    — ``tpu_chips`` (``tpuChips``).
"""

from __future__ import annotations

import html
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import unquote, urlparse

from ..core.api import APIServer, Invalid
from ..core.authz import Forbidden, ProfileRBACAuthorizer
from .dashboard import Dashboard
from .spawner import Spawner

USER_HEADER = "kubeflow-userid"

_STYLE = """
body{font-family:sans-serif;margin:2em;color:#202124}
h1,h2{font-weight:500} a{color:#1a73e8;text-decoration:none}
table{border-collapse:collapse;margin:1em 0}
td,th{border:1px solid #dadce0;padding:.4em .8em;text-align:left}
th{background:#f1f3f4} .phase-Running,.phase-Ready{color:#188038}
.phase-Failed{color:#d93025} .phase-Succeeded{color:#5f6368}
.card{display:inline-block;border:1px solid #dadce0;border-radius:8px;
padding:1em;margin:.5em;vertical-align:top}
"""


def _page(title: str, body: str) -> bytes:
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_STYLE}</style>"
            f"</head><body><h1>{html.escape(title)}</h1>{body}"
            f"</body></html>").encode()


def _esc(v) -> str:
    return html.escape(str(v))


def _phase_cell(phase: str) -> str:
    return f"<td class='phase-{_esc(phase)}'>{_esc(phase)}</td>"


def _sparkline(values: list[float], width: int = 240, height: int = 48) -> str:
    """Inline SVG polyline of a metric series (katib trial observations)."""
    if len(values) < 2:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{i * width / (len(values) - 1):.1f},"
        f"{height - (v - lo) / span * (height - 4) - 2:.1f}"
        for i, v in enumerate(values))
    return (f"<svg width='{width}' height='{height}'>"
            f"<polyline points='{pts}' fill='none' stroke='#1a73e8' "
            f"stroke-width='1.5'/></svg>")


_PHASE_FILL = {"Succeeded": "#e6f4ea", "Failed": "#fce8e6",
               "Running": "#e8f0fe", "Skipped": "#f1f3f4"}


def _dag_svg(tasks: dict, nodes: dict) -> str:
    """Layered DAG render of a pipeline run: tasks in topological columns
    (depth = longest dependency chain), edges as lines, fill by phase —
    the run-graph view the KFP frontend is known for, in one SVG."""
    if not tasks:
        return ""
    # iterative longest-chain layering: a thousand-task linear pipeline must
    # not blow the recursion limit mid-request
    depth: dict[str, int] = {}
    for root in tasks:
        stack = [root]
        while stack:
            t = stack[-1]
            if t in depth:
                stack.pop()
                continue
            deps = [x for x in tasks.get(t, {}).get("dependentTasks", [])
                    if x in tasks and x not in depth and x not in stack]
            if deps:
                stack.extend(deps)
                continue
            done = [x for x in tasks.get(t, {}).get("dependentTasks", [])
                    if x in depth]
            depth[t] = 1 + max((depth[x] for x in done), default=-1)
            stack.pop()
    cols: dict[int, list[str]] = {}
    for t in sorted(tasks):
        cols.setdefault(depth[t], []).append(t)
    bw, bh, gx, gy, pad = 150, 36, 60, 18, 10
    pos = {}
    for ci in sorted(cols):
        for ri, t in enumerate(cols[ci]):
            pos[t] = (pad + ci * (bw + gx), pad + ri * (bh + gy))
    width = pad * 2 + (max(cols) + 1) * bw + max(cols) * gx
    height = pad * 2 + max(len(v) for v in cols.values()) * (bh + gy) - gy
    parts = [f"<svg width='{width}' height='{height}' "
             f"style='border:1px solid #dadce0;border-radius:8px'>"]
    for t, spec in tasks.items():
        x1, y1 = pos[t]
        for dep in spec.get("dependentTasks", []):
            if dep not in pos:
                continue
            x0, y0 = pos[dep]
            parts.append(
                f"<line x1='{x0 + bw}' y1='{y0 + bh // 2}' x2='{x1}' "
                f"y2='{y1 + bh // 2}' stroke='#5f6368' stroke-width='1.2'/>")
    for t, (x, y) in pos.items():
        phase = nodes.get(t, {}).get("phase", "Pending")
        fill = _PHASE_FILL.get(phase, "#fff")
        parts.append(
            f"<g><rect x='{x}' y='{y}' width='{bw}' height='{bh}' rx='6' "
            f"fill='{fill}' stroke='#5f6368'/>"
            f"<text x='{x + bw / 2}' y='{y + bh / 2 + 4}' "
            f"text-anchor='middle' font-size='12'>{_esc(t)}</text></g>")
    parts.append("</svg>")
    return "".join(parts)


class DashboardWebUI:
    """One-port HTML shell: ``/`` overview, ``/ns/<ns>`` detail,
    ``/ns/<ns>/experiments/<name>`` katib results."""

    def __init__(self, api: APIServer, katib_service=None, port: int = 0,
                 cluster_admins=(), spawner: Optional[Spawner] = None,
                 pipeline_service=None, cull_idle_seconds: float = None):
        from .controllers import DEFAULT_CULL_IDLE_SECONDS

        self.api = api
        self.dashboard = Dashboard(api)
        self.authorizer = ProfileRBACAuthorizer(api, cluster_admins)
        self.katib = katib_service
        self.spawner = spawner
        self.pipelines = pipeline_service
        # for the namespace page's cull-countdown column; pass the culler's
        # actual threshold when it differs from the default
        self.cull_idle_seconds = (DEFAULT_CULL_IDLE_SECONDS
                                  if cull_idle_seconds is None
                                  else cull_idle_seconds)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                user = self.headers.get(USER_HEADER, "anonymous")
                parsed = urlparse(self.path)
                path = parsed.path
                from urllib.parse import parse_qs

                query = parse_qs(parsed.query)
                try:
                    out = outer._route(path, user, query)
                except Forbidden as e:
                    self._send(403, _page("Forbidden", f"<p>{_esc(e)}</p>"))
                    return
                except Exception as e:  # a dead handler thread (empty
                    # reply) is never the right answer to a render bug
                    self._send(500, _page("Error", f"<p>{_esc(e)}</p>"))
                    return
                if out is None:
                    self._send(404, _page("Not found", f"<p>{_esc(path)}</p>"))
                else:
                    self._send(200, out)

            def do_POST(self):
                user = self.headers.get(USER_HEADER, "anonymous")
                path = urlparse(self.path).path
                from urllib.parse import parse_qs

                parts = [unquote(p) for p in path.strip("/").split("/")]
                is_spawn = (len(parts) == 3 and parts[0] == "ns"
                            and parts[2] == "spawn"
                            and outer.spawner is not None)
                is_exp = (len(parts) == 4 and parts[0] == "ns"
                          and parts[2] == "experiments" and parts[3] == "new"
                          and outer.katib is not None)
                if not (is_spawn or is_exp):
                    self._send(404, _page("Not found", f"<p>{_esc(path)}</p>"))
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    form = {k: v[0] for k, v in
                            parse_qs(self.rfile.read(n).decode()).items()}
                    if is_spawn:
                        outer._spawn(user, parts[1], form)
                    else:
                        outer._create_experiment(user, parts[1], form)
                except Forbidden as e:
                    self._send(403, _page("Forbidden", f"<p>{_esc(e)}</p>"))
                    return
                except (KeyError, ValueError, Invalid, TypeError,
                        AttributeError) as e:
                    # KeyError = required form field missing; TypeError/
                    # AttributeError = valid JSON of the wrong shape. A dead
                    # handler thread (empty reply) is never the right answer
                    # to bad form data
                    self._send(400, _page("Invalid", f"<p>{_esc(e)}</p>"))
                    return
                except Exception as e:  # render bugs -> 500, like do_GET
                    self._send(500, _page("Error", f"<p>{_esc(e)}</p>"))
                    return
                # POST-redirect-GET; re-quote the decoded segments — echoing
                # them raw would let %0d%0a split the response (CRLF header
                # injection)
                from urllib.parse import quote

                loc = f"/ns/{quote(parts[1], safe='')}"
                if is_exp:
                    loc += f"/experiments/{quote(form.get('name', ''), safe='')}"
                self.send_response(303)
                self.send_header("Location", loc)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _send(self, code: int, payload: bytes):
                self.send_response(code)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def shutdown(self) -> None:
        self._httpd.shutdown()

    def _authz(self, user: str, verb: str, kind: str, ns: str) -> None:
        if not self.authorizer.authorize(user, verb, kind, ns):
            raise Forbidden(f"user {user!r} cannot {verb} {kind} in {ns!r}")

    # ------------------------------------------------------------- routing

    def _route(self, path: str, user: str,
               query: Optional[dict] = None) -> Optional[bytes]:
        if path == "/healthz":
            return b"ok"
        if path == "/":
            return self._overview(user)
        parts = [unquote(p) for p in path.strip("/").split("/")]
        if len(parts) == 2 and parts[0] == "ns":
            return self._namespace(user, parts[1])
        if (len(parts) == 3 and parts[0] == "ns" and parts[2] == "spawn"
                and self.spawner is not None):
            return self._spawn_form(user, parts[1])
        if (len(parts) == 4 and parts[0] == "ns" and parts[2] == "experiments"
                and self.katib is not None):
            if parts[3] == "new":
                return self._experiment_form(user, parts[1])
            return self._experiment(user, parts[1], parts[3])
        if len(parts) == 4 and parts[0] == "ns" and parts[2] == "isvc":
            return self._isvc(user, parts[1], parts[3])
        if path == "/pipelines" and self.pipelines is not None:
            return self._pipelines(user)
        if path == "/compare" and self.pipelines is not None:
            return self._compare(user, (query or {}).get("runs", []))
        if (len(parts) == 2 and parts[0] == "runs"
                and self.pipelines is not None):
            return self._run(user, parts[1])
        return None

    # --------------------------------------------------------------- pages

    def _overview(self, user: str) -> bytes:
        ov = self.dashboard.overview(user)
        cards = []
        for card in ov["namespaces"]:
            ns = card["namespace"]
            rows = "".join(
                f"<tr><td>{_esc(k)}</td><td>{v}</td></tr>"
                for k, v in sorted(card["workloads"].items()))
            cards.append(
                f"<div class='card'><h2><a href='/ns/{_esc(ns)}'>{_esc(ns)}"
                f"</a></h2><table>{rows}</table>"
                f"<p>{card['running']} running · "
                f"{card['gpus_requested']:.0f} GPUs</p></div>")
        t = ov["totals"]
        nav = ("<p><a href='/pipelines'>Pipelines</a></p>"
               if self.pipelines is not None else "")
        body = (f"<p>Signed in as <b>{_esc(user)}</b> — "
                f"{t['workloads']} workloads, {t['running']} running, "
                f"{t['gpus_requested']:.0f} GPUs requested</p>"
                + nav + "".join(cards))
        return _page("Kubeflow-TPU", body)

    def _namespace(self, user: str, ns: str) -> bytes:
        self._authz(user, "list", "Pod", ns)
        summary = self.dashboard.summary(ns)
        quota = self.dashboard.quota(ns)
        activity = self.dashboard.activity(ns)
        def name_cell(kind, i):
            if kind == "Experiment" and self.katib is not None:
                return (f"<a href='/ns/{_esc(ns)}/experiments/"
                        f"{_esc(i['name'])}'>{_esc(i['name'])}</a>")
            if kind == "InferenceService":
                return (f"<a href='/ns/{_esc(ns)}/isvc/"
                        f"{_esc(i['name'])}'>{_esc(i['name'])}</a>")
            return _esc(i["name"])

        sections = []
        for kind, info in summary["resources"].items():
            if kind == "Notebook":
                sections.append(self._notebook_section(ns, info))
                continue
            rows = "".join(
                f"<tr><td>{name_cell(kind, i)}</td>{_phase_cell(i['phase'])}</tr>"
                for i in info["items"])
            new_link = (f" <a href='/ns/{_esc(ns)}/experiments/new'>new</a>"
                        if kind == "Experiment" and self.katib is not None
                        else "")
            sections.append(f"<h2>{_esc(kind)} ({info['count']}){new_link}</h2>"
                            f"<table><tr><th>name</th><th>phase</th></tr>"
                            f"{rows}</table>")
        qrows = "".join(
            f"<tr><td>{_esc(res)}</td><td>{quota['used'].get(res, 0.0):g}</td>"
            f"<td>{_esc(hard)}</td></tr>"
            for res, hard in sorted(quota["hard"].items()))
        if qrows:
            sections.append("<h2>Quota</h2><table><tr><th>resource</th>"
                            f"<th>used</th><th>hard</th></tr>{qrows}</table>")
        arows = "".join(
            f"<tr><td>{_esc(e['type'])}</td><td>{_esc(e['object'])}</td>"
            f"<td>{_esc(e['reason'])}</td><td>{_esc(e['message'])}</td></tr>"
            for e in activity)
        if arows:
            sections.append("<h2>Recent activity</h2><table><tr><th>type</th>"
                            "<th>object</th><th>reason</th><th>message</th>"
                            f"</tr>{arows}</table>")
        return _page(f"Namespace {ns}", "".join(sections))

    def _isvc(self, user: str, ns: str, name: str) -> Optional[bytes]:
        """InferenceService detail — what upstream's KServe models-web-app
        shows: per-component status with revisions and the canary traffic
        split, conditions, and the serving URLs (SURVEY §2a KServe rows)."""
        self._authz(user, "get", "InferenceService", ns)
        isvc = self.dashboard.api.try_get("InferenceService", name, ns)
        if isvc is None:
            return None
        spec, status = isvc.get("spec", {}), isvc.get("status", {})
        sections = []
        urls = "".join(
            f"<tr><td>{_esc(label)}</td><td>{_esc(url)}</td></tr>"
            for label, url in (("external", status.get("url")),
                               ("in-cluster", (status.get("address") or {}).get("url")))
            if url)
        if urls:
            sections.append(f"<h2>URLs</h2><table>{urls}</table>")
        for comp, info in (status.get("components") or {}).items():
            cspec = spec.get(comp, {})
            model = cspec.get("model", {})
            head = (f"<h2>{_esc(comp)}</h2><p>format "
                    f"<b>{_esc(model.get('modelFormat', {}).get('name', '-'))}</b>"
                    f" · storage <code>{_esc(model.get('storageUri', '-'))}</code>"
                    f" · ready revision <code>"
                    f"{_esc(info.get('latestReadyRevision') or '-')}</code></p>")
            trows = "".join(
                f"<tr><td><code>{_esc(t['revisionName'])}</code></td>"
                f"<td>{_esc(t['percent'])}%</td>"
                f"<td>{_esc('latest' if t.get('latestRevision') else '')}</td></tr>"
                for t in info.get("traffic", []))
            table = (f"<table><tr><th>revision</th><th>traffic</th><th></th>"
                     f"</tr>{trows}</table>" if trows else "")
            sections.append(head + table)
        crows = "".join(
            f"<tr><td>{_esc(c['type'])}</td>{_phase_cell(c['status'])}"
            f"<td>{_esc(c.get('reason', ''))}</td></tr>"
            for c in status.get("conditions", []))
        if crows:
            sections.append("<h2>Conditions</h2><table><tr><th>type</th>"
                            f"<th>status</th><th>reason</th></tr>{crows}</table>")
        return _page(f"InferenceService {name}", "".join(sections))

    def _notebook_section(self, ns: str, info: dict) -> str:
        """Notebook rows with the culling status column upstream's
        jupyter-web-app shows: last-activity age and time-to-cull, or the
        culled state (SURVEY §2a Jupyter row; the activity signal is the
        last-activity annotation the NotebookCuller reads)."""
        import time as _time

        from . import api as papi_plat

        by_name = {nb["metadata"]["name"]: nb
                   for nb in self.api.list("Notebook", namespace=ns)}
        rows = []
        for i in info["items"]:
            nb = by_name.get(i["name"], {})
            ann = nb.get("metadata", {}).get("annotations", {})
            if ann.get(papi_plat.CULLED_ANNOTATION) == "true":
                status = "<i>culled (idle)</i>"
            else:
                last = float(ann.get(
                    papi_plat.LAST_ACTIVITY_ANNOTATION,
                    nb.get("metadata", {}).get("creationTimestamp", 0)))
                idle = max(0.0, _time.time() - last)
                left = self.cull_idle_seconds - idle
                status = (f"active {idle:.0f}s ago · culls in {left:.0f}s"
                          if left > 0 else
                          f"active {idle:.0f}s ago · cull pending")
            rows.append(f"<tr><td>{_esc(i['name'])}</td>"
                        f"{_phase_cell(i['phase'])}<td>{status}</td></tr>")
        return (f"<h2>Notebook ({info['count']})</h2>"
                "<table><tr><th>name</th><th>phase</th><th>activity</th></tr>"
                f"{''.join(rows)}</table>")

    def _spawn_form(self, user: str, ns: str) -> bytes:
        """The jupyter-web-app form: options straight from the spawner
        config — the accelerator dropdown is a count of cards."""
        self._authz(user, "create", "Notebook", ns)
        opts = self.spawner.options()

        def select(field, values, default=None):
            choices = "".join(
                f"<option{' selected' if str(v) == str(default) else ''}>"
                f"{_esc(v)}</option>" for v in values)
            return (f"<label>{_esc(field)} "
                    f"<select name='{_esc(field)}'>{choices}</select></label> ")

        body = (f"<form method='post' action='/ns/{_esc(ns)}/spawn'>"
                "<label>name <input name='name' required></label> "
                + select("image", opts["images"], opts["defaultImage"])
                + select("cpu", opts["cpu"], "1")
                + select("memory", opts["memory"], "2Gi")
                + select("gpus", opts["gpus"], 0)
                + "<button type='submit'>Launch</button></form>")
        return _page(f"New notebook in {ns}", body)

    def _spawn(self, user: str, ns: str, form: dict) -> None:
        self._authz(user, "create", "Notebook", ns)
        self.spawner.spawn(
            form["name"], ns, image=form.get("image") or None,
            cpu=form.get("cpu", "1"), memory=form.get("memory", "2Gi"),
            gpus=int(form.get("gpus", 0)))

    # ------------------------------------------------------ pipelines (KFP)

    def _pipelines(self, user: str) -> bytes:
        """Pipelines landing: uploaded pipelines + runs the user may see
        (runs are namespaced; rows the user can't list are filtered, as the
        upstream frontend does via the API server's authz)."""
        plist = "".join(f"<li>{_esc(p)}</li>"
                        for p in self.pipelines.list_pipelines())
        rows = []
        allowed: dict[str, bool] = {}  # one RBAC resolution per namespace
        for r in reversed(self.pipelines.list_runs()):
            ns = r.get("namespace", "default")
            if ns not in allowed:
                allowed[ns] = self.authorizer.authorize(
                    user, "list", "Workflow", ns)
            if not allowed[ns]:
                continue
            rows.append(
                f"<tr><td><input type='checkbox' name='runs' "
                f"value='{_esc(r['run'])}'></td>"
                f"<td><a href='/runs/{_esc(r['run'])}'>{_esc(r['run'])}"
                f"</a></td><td>{_esc(r.get('pipeline', ''))}</td>"
                f"<td>{_esc(r.get('experiment', ''))}</td>"
                f"{_phase_cell(r.get('phase', 'Pending'))}</tr>")
        body = (f"<h2>Pipelines</h2><ul>{plist or '<li>none uploaded</li>'}</ul>"
                "<h2>Runs</h2><form method='get' action='/compare'>"
                "<table><tr><th></th><th>run</th><th>pipeline</th>"
                "<th>experiment</th><th>phase</th></tr>"
                + "".join(rows) + "</table>"
                "<button type='submit'>Compare selected</button></form>")
        return _page("Pipelines", body)

    # ------------------------------------------------------- run artifacts

    @staticmethod
    def _metrics_of(nodes: dict) -> dict:
        """{'task/metric': value} from every system.Metrics output artifact
        — the ONE walker both the run page and /compare render from."""
        out = {}
        for tname, node in (nodes or {}).items():
            for art in (node.get("outputArtifacts") or {}).values():
                if art.get("type") != "system.Metrics":
                    continue
                for k, v in (art.get("metadata") or {}).items():
                    out[f"{tname}/{k}"] = v
        return out

    def _run_artifacts(self, nodes: dict) -> str:
        """Artifact section of a run page: every task's output artifacts
        with type + metadata, Metrics metadata rendered as a metric table,
        and a short inline preview of small text artifacts — the viewing
        capability of upstream's artifact pane (SURVEY §2a KFP frontend)."""
        store = getattr(self.pipelines, "store", None)
        arows = []
        mrows = [
            f"<tr><td>{_esc(k.split('/', 1)[0])}</td>"
            f"<td>{_esc(k.split('/', 1)[1])}</td><td>{_esc(v)}</td></tr>"
            for k, v in sorted(self._metrics_of(nodes).items())]
        for tname in sorted(nodes):
            for aname, art in sorted(
                    (nodes[tname].get("outputArtifacts") or {}).items()):
                meta = art.get("metadata") or {}
                preview = ""
                if store is not None and art.get("uri"):
                    try:
                        # bounded read: never pull a multi-GB artifact into
                        # the webui process for a page render; 4096 is also
                        # the display threshold, so a rendered preview is
                        # never silently truncated
                        head, size = store.get_head(art["uri"], 4096)
                        preview = (f"<pre>{_esc(head.decode('utf-8', 'replace'))}"
                                   f"</pre>" if size <= 4096
                                   else f"<i>{size} bytes</i>")
                    except (OSError, ValueError):
                        pass  # directory artifact / not yet written
                meta_txt = ", ".join(f"{_esc(k)}={_esc(v)}"
                                     for k, v in sorted(meta.items()))
                arows.append(
                    f"<tr><td>{_esc(tname)}</td><td>{_esc(aname)}</td>"
                    f"<td>{_esc(art.get('type', ''))}</td>"
                    f"<td>{_esc(art.get('uri', ''))}</td>"
                    f"<td>{meta_txt}</td><td>{preview}</td></tr>")
        out = ""
        if mrows:
            out += ("<h2>Metrics</h2><table><tr><th>task</th><th>metric</th>"
                    f"<th>value</th></tr>{''.join(mrows)}</table>")
        if arows:
            out += ("<h2>Artifacts</h2><table><tr><th>task</th><th>artifact"
                    "</th><th>type</th><th>uri</th><th>metadata</th>"
                    f"<th>preview</th></tr>{''.join(arows)}</table>")
        return out

    def _compare(self, user: str, run_ids: list) -> Optional[bytes]:
        """Side-by-side run comparison: phases, arguments, and every
        Metrics-artifact scalar — upstream's 'Compare runs' view."""
        run_ids = [r for r in run_ids if r][:8]  # bound the fan-out
        if len(run_ids) < 2:
            return _page("Compare runs",
                         "<p>select at least two runs on "
                         "<a href='/pipelines'>the runs page</a></p>")
        recs = {}
        for rid in run_ids:
            try:
                rec = self.pipelines.get_run(rid)
            except KeyError:
                return None
            self._authz(user, "list", "Workflow",
                        rec.get("namespace", "default"))
            recs[rid] = rec
        head = "".join(f"<th>{_esc(r)}</th>" for r in run_ids)
        rows = [
            "<tr><td>pipeline</td>" + "".join(
                f"<td>{_esc(recs[r].get('pipeline', ''))}</td>"
                for r in run_ids) + "</tr>",
            "<tr><td>phase</td>" + "".join(
                _phase_cell(recs[r].get("phase", "Pending"))
                for r in run_ids) + "</tr>",
        ]
        argkeys = sorted({k for r in run_ids
                          for k in (recs[r].get("arguments") or {})})
        for k in argkeys:
            rows.append(f"<tr><td>arg {_esc(k)}</td>" + "".join(
                f"<td>{_esc((recs[r].get('arguments') or {}).get(k, ''))}</td>"
                for r in run_ids) + "</tr>")
        metrics = {rid: self._metrics_of(rec.get("nodes"))
                   for rid, rec in recs.items()}
        for k in sorted({k for v in metrics.values() for k in v}):
            rows.append(f"<tr><td>{_esc(k)}</td>" + "".join(
                f"<td>{_esc(metrics[r].get(k, ''))}</td>"
                for r in run_ids) + "</tr>")
        body = (f"<table><tr><th></th>{head}</tr>{''.join(rows)}</table>"
                "<p><a href='/pipelines'>back to runs</a></p>")
        return _page("Compare runs", body)

    def _run(self, user: str, run_id: str) -> Optional[bytes]:
        try:
            rec = self.pipelines.get_run(run_id)
        except KeyError:
            return None
        ns = rec.get("namespace", "default")
        self._authz(user, "list", "Workflow", ns)
        # ONE Workflow snapshot for phase, nodes AND spec tasks — get_run's
        # internal fetch is a different deepcopy, and two snapshots of a
        # live run can disagree between the header and the graph
        wf = self.api.try_get("Workflow", run_id, ns)
        tasks = ((wf or {}).get("spec", {}).get("pipelineSpec", {})
                 .get("root", {}).get("dag", {}).get("tasks", {}))
        nodes = (wf or {}).get("status", {}).get("nodes",
                                                 rec.get("nodes", {}))
        if wf is not None:
            rec["phase"] = wf.get("status", {}).get("phase", rec.get("phase"))
        args = ", ".join(f"{_esc(k)}={_esc(v)}"
                         for k, v in (rec.get("arguments") or {}).items())
        body = (f"<p>pipeline: <b>{_esc(rec.get('pipeline', ''))}</b> · "
                f"phase: <b>{_esc(rec.get('phase', 'Pending'))}</b>"
                + (f" · arguments: {args}" if args else "") + "</p>"
                + _dag_svg(tasks, nodes))
        rows = "".join(
            f"<tr><td>{_esc(t)}</td>"
            f"{_phase_cell(nodes.get(t, {}).get('phase', 'Pending'))}"
            f"<td>{nodes.get(t, {}).get('retries', 0)}</td>"
            f"<td>{_esc(nodes.get(t, {}).get('message', ''))}</td></tr>"
            for t in sorted(tasks))
        body += ("<h2>Tasks</h2><table><tr><th>task</th><th>phase</th>"
                 f"<th>retries</th><th>message</th></tr>{rows}</table>")
        body += self._run_artifacts(nodes)
        return _page(f"Run {run_id}", body)

    _DEFAULT_PARAMS = ('[{"name": "lr", "parameterType": "double", '
                       '"feasibleSpace": {"min": 0.01, "max": 1.0}}]')
    # restartPolicy Never matters: the kubelet default (Always) would
    # restart the trial pod forever and the trial would never complete
    _DEFAULT_TRIAL = ('{"apiVersion": "v1", "kind": "Pod", "spec": '
                      '{"restartPolicy": "Never", "containers": '
                      '[{"name": "main", "command": ["python3", "-c", '
                      '"print(\'metric=${trialParameters.lr}\')"]}]}}')

    def _experiment_form(self, user: str, ns: str) -> bytes:
        """The katib-ui submit flow: a form that builds an Experiment CR —
        algorithm dropdown straight from the suggester registry, parameters
        and trial spec as JSON (upstream's YAML-paste equivalent)."""
        self._authz(user, "create", "Experiment", ns)
        from ..katib.suggest import algorithm_names

        algos = "".join(f"<option>{_esc(a)}</option>"
                        for a in algorithm_names())
        body = (
            f"<form method='post' action='/ns/{_esc(ns)}/experiments/new'>"
            "<p><label>name <input name='name' required></label> "
            "<label>objective metric <input name='metric' required></label> "
            "<label>type <select name='type'><option>maximize</option>"
            "<option>minimize</option></select></label> "
            "<label>goal <input name='goal' placeholder='optional'></label></p>"
            f"<p><label>algorithm <select name='algorithm'>{algos}</select>"
            "</label> <label>max trials "
            "<input name='max_trials' value='10' size='4'></label> "
            "<label>parallel <input name='parallel_trials' value='3' "
            "size='4'></label></p>"
            "<p><label>parameters (JSON list)<br>"
            f"<textarea name='parameters' rows='4' cols='80'>"
            f"{_esc(self._DEFAULT_PARAMS)}</textarea></label></p>"
            "<p><label>trial spec (JSON, ${trialParameters.x} placeholders)"
            f"<br><textarea name='trial_spec' rows='6' cols='80'>"
            f"{_esc(self._DEFAULT_TRIAL)}</textarea></label></p>"
            "<button type='submit'>Create experiment</button></form>")
        return _page(f"New experiment in {ns}", body)

    def _create_experiment(self, user: str, ns: str, form: dict) -> None:
        import json as _json

        self._authz(user, "create", "Experiment", ns)
        from ..katib.api import Parameter, experiment

        if form["name"] == "new":
            # /experiments/new is the form route — an experiment with that
            # name would render the blank form instead of its own results
            raise ValueError("'new' is a reserved experiment name")
        raw_params = _json.loads(form["parameters"])
        if not isinstance(raw_params, list):
            raise ValueError("parameters must be a JSON list")
        params = [Parameter(p["name"], p["parameterType"],
                            min=p.get("feasibleSpace", {}).get("min"),
                            max=p.get("feasibleSpace", {}).get("max"),
                            step=p.get("feasibleSpace", {}).get("step"),
                            list=p.get("feasibleSpace", {}).get("list"))
                  for p in raw_params]
        goal = form.get("goal", "").strip()
        exp = experiment(
            form["name"], params, _json.loads(form["trial_spec"]),
            objective_metric=form["metric"],
            objective_type=form.get("type", "maximize"),
            goal=float(goal) if goal else None,
            algorithm=form.get("algorithm", "random"),
            max_trials=int(form.get("max_trials", 10)),
            parallel_trials=int(form.get("parallel_trials", 3)),
            namespace=ns)
        self.api.create(exp)

    def _experiment(self, user: str, ns: str, name: str) -> Optional[bytes]:
        self._authz(user, "list", "Experiment", ns)
        exp = self.katib.get_experiment(name, namespace=ns)
        if exp is None:
            return None
        objective = exp["spec"].get("objective", {})
        metric = objective.get("objectiveMetricName", "")
        rows = []
        for t in exp["trials"]:
            assignments = ", ".join(
                f"{_esc(a['name'])}={_esc(a['value'])}"
                for a in t.get("parameterAssignments", []))
            series = [rec["value"] for rec in
                      self.katib.get_observation_log(t["name"], metric)
                      ] if metric else []
            best = t.get("observation", {}).get("metrics") or []
            best_txt = ", ".join(
                f"{_esc(m.get('name'))}={_esc(m.get('latest'))}" for m in best)
            rows.append(
                f"<tr><td>{_esc(t['name'])}</td>{_phase_cell(t['status'])}"
                f"<td>{assignments}</td><td>{best_txt}</td>"
                f"<td>{_sparkline(series)}</td></tr>")
        optimal = exp.get("currentOptimalTrial") or {}
        opt_txt = (f" · best: <b>{_esc(optimal.get('bestTrialName', ''))}</b>"
                   if optimal.get("bestTrialName") else "")
        body = (f"<p>status: <b>{_esc(exp['status'])}</b> · objective: "
                f"{_esc(objective.get('type', ''))} <b>{_esc(metric)}</b> · "
                f"{len(exp['trials'])} trials{opt_txt}</p>"
                "<table><tr><th>trial</th><th>phase</th><th>parameters</th>"
                f"<th>observation</th><th>{_esc(metric)}</th></tr>"
                + "".join(rows) + "</table>")
        return _page(f"Experiment {name}", body)
