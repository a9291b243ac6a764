"""Global name → object registry (a copy of llava_align_tpu/framework/
registry.py, the source unchanged; tests/test_torch_copies.py holds it to
it). The port's tasks register here; the JAX package's registry is
another object.

Capability parity: reference experiments/lavis/common/registry.py.
"""

from __future__ import annotations

from typing import Any, Dict, List


class Registry:
    def __init__(self):
        self._groups: Dict[str, Dict[str, Any]] = {
            "model": {},
            "task": {},
            "builder": {},
            "processor": {},
            "runner": {},
            "lr_scheduler": {},
            "paths": {},
            "state": {},
        }

    # -- generic ------------------------------------------------------------

    def register(self, group: str, name: str, obj: Any = None):
        if group not in self._groups:
            self._groups[group] = {}
        table = self._groups[group]

        def _do(o):
            if name in table and table[name] is not o:
                raise KeyError(f"{group}:{name} already registered")
            table[name] = o
            return o

        if obj is None:  # decorator form
            return _do
        return _do(obj)

    def get(self, group: str, name: str, default: Any = None) -> Any:
        return self._groups.get(group, {}).get(name, default)

    def list(self, group: str) -> List[str]:
        return sorted(self._groups.get(group, {}).keys())

    # -- named helpers (reference API surface) -------------------------------

    def register_model(self, name: str):
        return self.register("model", name)

    def register_task(self, name: str):
        return self.register("task", name)

    def register_builder(self, name: str):
        return self.register("builder", name)

    def register_processor(self, name: str):
        return self.register("processor", name)

    def register_runner(self, name: str):
        return self.register("runner", name)

    def register_lr_scheduler(self, name: str):
        return self.register("lr_scheduler", name)

    def register_path(self, name: str, path: str):
        self.register("paths", name, path)

    def get_model_class(self, name: str):
        return self.get("model", name)

    def get_task_class(self, name: str):
        return self.get("task", name)

    def get_builder_class(self, name: str):
        return self.get("builder", name)

    def get_processor_class(self, name: str):
        return self.get("processor", name)

    def get_runner_class(self, name: str):
        return self.get("runner", name)

    def get_lr_scheduler_class(self, name: str):
        return self.get("lr_scheduler", name)

    def get_path(self, name: str):
        return self.get("paths", name)

    # mutable global state (reference registry.mapping['state'])
    def register_state(self, name: str, value: Any):
        self._groups["state"][name] = value

    def get_state(self, name: str, default: Any = None):
        return self._groups["state"].get(name, default)


registry = Registry()
