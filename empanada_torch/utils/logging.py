"""Experiment tracking.

mlflow where it imports; otherwise a run directory with the layout
mlflow would hold: meta.json, params.json, metrics.csv (step-stamped
append) and an artifacts/ folder, under ``$EMPANADA_RUNS_DIR`` (default
``./runs``). mlflow is imported only when a logger is made.
"""

from __future__ import annotations

import csv
import json
import os
import time
import uuid

__all__ = ["ExperimentLogger"]

def _mlflow_imports():
    try:
        import mlflow  # noqa: F401
    except Exception:
        return False
    return True


class ExperimentLogger:
    def __init__(self, experiment="Default", run_name=None, run_id=None,
                 root=None):
        self.experiment = experiment
        self.run_name = run_name
        self.use_mlflow = _mlflow_imports()
        if self.use_mlflow:
            import mlflow

            mlflow.set_experiment(experiment)
            self._run = mlflow.start_run(run_id=run_id,
                                         run_name=run_name)
            self.run_id = self._run.info.run_id
            self.run_dir = None
        else:
            root = root or os.environ.get("EMPANADA_RUNS_DIR", "./runs")
            self.run_id = run_id or uuid.uuid4().hex[:16]
            self.run_dir = os.path.join(root, experiment, self.run_id)
            os.makedirs(os.path.join(self.run_dir, "artifacts"),
                        exist_ok=True)
            meta = {"run_name": run_name, "run_id": self.run_id,
                    "experiment": experiment, "start_time": time.time()}
            with open(os.path.join(self.run_dir, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2)

    def log_params(self, params: dict):
        if self.use_mlflow:
            import mlflow

            for k, v in params.items():
                mlflow.log_param(k, v)
            return
        path = os.path.join(self.run_dir, "params.json")
        existing = {}
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
        existing.update({k: repr(v) if not isinstance(
            v, (str, int, float, bool, type(None))) else v
            for k, v in params.items()})
        with open(path, "w") as f:
            json.dump(existing, f, indent=2)

    def log_metrics(self, metrics: dict, step=None):
        if self.use_mlflow:
            import mlflow

            mlflow.log_metrics(
                {k: float(v) for k, v in metrics.items()}, step=step)
            return
        path = os.path.join(self.run_dir, "metrics.csv")
        new = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["time", "step", "metric", "value"])
            now = time.time()
            for k, v in metrics.items():
                w.writerow([now, step, k, float(v)])

    def artifact_path(self, name):
        """Directory path to save an artifact file into."""
        if self.use_mlflow:
            import tempfile

            return tempfile.mkdtemp()
        return os.path.join(self.run_dir, "artifacts")

    def log_artifact(self, filepath):
        if self.use_mlflow:
            import mlflow

            mlflow.log_artifact(filepath)

    def end(self):
        if self.use_mlflow:
            import mlflow

            mlflow.end_run()
        elif self.run_dir:
            with open(os.path.join(self.run_dir, "meta.json")) as f:
                meta = json.load(f)
            meta["end_time"] = time.time()
            with open(os.path.join(self.run_dir, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2)
