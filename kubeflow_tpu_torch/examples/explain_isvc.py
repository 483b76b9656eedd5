"""Explain an InferenceService's predictions (the Alibi-explainer flow).

The port's counterpart of ``kubeflow_tpu/examples/explain_isvc.py``, on the
port's own control plane and runtime: what a user of the reference
platform did with a KServe explainer component (spec.explainer → Alibi
server pod → calls the predictor), done with the port's explainer runtime
(serving/explainers.py):

  * ``shap``: black-box Shapley values — the explainer pod interrogates
    the predictor over HTTP (PREDICTOR_HOST), exact for <=12 features.
  * ``integrated_gradients``: white-box path-integral attributions over a
    ``load_torch`` model.

Run: python -m kubeflow_tpu_torch.examples.explain_isvc
Prints the prediction and per-feature attributions for one instance; on a
linear model the attributions are exactly w * (x - background_mean).  No
pod of this example asks for a card, so the cluster has CPU nodes only.
"""

from __future__ import annotations

import json
import os
import tempfile
import textwrap


def main() -> None:
    from kubeflow_tpu_torch.core.cluster import Cluster
    from kubeflow_tpu_torch.serving import install
    from kubeflow_tpu_torch.serving.api import inference_service

    c = Cluster(cpu_nodes=1, base_env={"PYTHONPATH": os.getcwd()})
    router, proxy = install(c.api, c.manager)
    try:
        td = tempfile.mkdtemp(prefix="explain-")
        pred_dir = os.path.join(td, "model")
        os.makedirs(pred_dir)
        # graftlint: disable=atomic-write -- demo scaffolding into a
        # directory this script just created; no concurrent reader
        with open(os.path.join(pred_dir, "model.py"), "w") as f:
            f.write(textwrap.dedent("""
                W = [1.5, -2.0, 0.5, 3.0]   # a linear "credit score" model
                def predict(instances):
                    return [sum(w * v for w, v in zip(W, row)) for row in instances]
            """))
        expl_dir = os.path.join(td, "explainer")
        os.makedirs(expl_dir)
        # graftlint: disable=atomic-write -- demo scaffolding into a
        # directory this script just created; no concurrent reader
        with open(os.path.join(expl_dir, "explainer.json"), "w") as f:
            json.dump({"method": "shap",
                       "background": [[0.0, 0.0, 0.0, 0.0]]}, f)

        c.apply(inference_service(
            "scorer", model_format="pyfunc",
            storage_uri=f"file://{pred_dir}",
            explainer={"model": {"modelFormat": {"name": "explainer"},
                       "storageUri": f"file://{expl_dir}"}}))

        def ready():
            isvc = c.api.get("InferenceService", "scorer")
            conds = {cc["type"]: cc["status"]
                     for cc in isvc.get("status", {}).get("conditions", [])}
            return conds.get("Ready") == "True"
        assert c.wait_for(ready, timeout=120)

        x = [2.0, -1.0, 0.0, 1.0]
        pred = router.predict("scorer", {"instances": [x]})
        expl = router.explain("scorer", {"instances": [x]})
        print("prediction:", pred["predictions"][0])
        print("shap attributions:",
              [round(v, 4) for v in expl["explanations"][0]["shap_values"]])
    finally:
        proxy.shutdown()
        c.shutdown()


if __name__ == "__main__":
    main()
