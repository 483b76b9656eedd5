"""Notebook spawner backend (jupyter-web-app equivalent).

Upstream analogue (UNVERIFIED, SURVEY.md §2a/§5): the jupyter-web-app Flask
backend rendering ``spawner_ui_config.yaml`` — default images, CPU/RAM
options, and the accelerator dropdown.  The config is a typed dataclass
rendered into the same ConfigMap semantics (SURVEY.md §5 config system).

The port's copy of ``kubeflow_tpu/platform/spawner.py``.  The accelerator
dropdown counts ``nvidia.com/gpu`` cards, as upstream's does.  Renamed for
it, each beside the reference's name:
  * ``SpawnerConfig.gpu_options`` — ``tpu_options`` (the same counts);
  * the ConfigMap's ``gpus`` key — ``tpuChips``;
  * ``Spawner.spawn(..., gpus=N)`` — ``tpu_chips=N``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

from ..core.api import AlreadyExists, APIServer
from . import api as papi


@dataclass(frozen=True)
class SpawnerConfig:
    """The spawner form's option space (spawner_ui_config.yaml equivalent)."""

    images: tuple = (
        "jupyter-tpu:v5e",          # TPU-VM image: jax preinstalled
        "jupyter-scipy:latest",
        "jupyter-pytorch-xla:v5e",
    )
    default_image: str = "jupyter-tpu:v5e"
    cpu_options: tuple = ("0.5", "1", "2", "4")
    memory_options: tuple = ("1Gi", "2Gi", "4Gi", "8Gi")
    # the accelerator list: cards a notebook may hold
    gpu_options: tuple = (0, 1, 4, 8)
    default_command: tuple = ("python", "-c", "import time; time.sleep(3600)")

    def to_configmap(self, namespace: str = "kubeflow") -> dict:
        return {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": "spawner-ui-config", "namespace": namespace},
            "data": {
                "spawner_ui_config.json": json.dumps(
                    {
                        "images": list(self.images),
                        "defaultImage": self.default_image,
                        "cpu": list(self.cpu_options),
                        "memory": list(self.memory_options),
                        "gpus": list(self.gpu_options),
                    },
                    sort_keys=True,
                )
            },
        }


class Spawner:
    """Form-validated Notebook creation + activity tracking."""

    def __init__(self, api: APIServer, config: SpawnerConfig = SpawnerConfig()):
        self.api = api
        self.config = config
        try:
            api.create(config.to_configmap())
        except AlreadyExists:
            pass

    def options(self) -> dict:
        cm = self.api.get("ConfigMap", "spawner-ui-config", "kubeflow")
        return json.loads(cm["data"]["spawner_ui_config.json"])

    def spawn(
        self,
        name: str,
        namespace: str,
        image: Optional[str] = None,
        cpu: str = "1",
        memory: str = "2Gi",
        gpus: int = 0,
        command: Optional[list] = None,
        env: Optional[dict] = None,
    ) -> dict:
        opts = self.options()
        image = image or opts["defaultImage"]
        if image not in opts["images"]:
            raise ValueError(f"image {image!r} not in spawner config {opts['images']}")
        if cpu not in opts["cpu"]:
            raise ValueError(f"cpu {cpu!r} not in {opts['cpu']}")
        if memory not in opts["memory"]:
            raise ValueError(f"memory {memory!r} not in {opts['memory']}")
        if gpus not in opts["gpus"]:
            raise ValueError(f"gpus {gpus} not in {opts['gpus']}")
        nb = papi.notebook(
            name,
            namespace,
            list(command or self.config.default_command),
            cpu=cpu,
            memory=memory,
            gpus=gpus,
            env=env,
        )
        nb["metadata"].setdefault("annotations", {})[papi.LAST_ACTIVITY_ANNOTATION] = str(time.time())
        nb["metadata"]["annotations"]["notebooks.kubeflow.org/image"] = image
        return self.api.create(nb)

    def touch(self, name: str, namespace: str) -> None:
        """Record user activity (resets the culling clock, un-culls)."""
        self.api.patch(
            "Notebook",
            name,
            {
                "metadata": {
                    "annotations": {
                        papi.LAST_ACTIVITY_ANNOTATION: str(time.time()),
                        papi.CULLED_ANNOTATION: None,
                    }
                }
            },
            namespace,
        )
