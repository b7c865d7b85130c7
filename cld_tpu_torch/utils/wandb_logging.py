"""Optional wandb sink for the trainers' metric records (port of
`cld_tpu/utils/wandb_logging.py`): metrics stream to wandb when the package,
its credentials and its server are there; otherwise the sink is inactive,
keeps the reason, and the JSONL / stdout logger is the only record."""

from __future__ import annotations

from typing import Dict, Optional


class WandbSink:
    def __init__(self, project: str, run_name: Optional[str] = None,
                 config: Optional[dict] = None):
        self._reason = None
        try:
            import wandb

            self._run = wandb.init(project=project, name=run_name, config=config)
            self._wandb = wandb
        except Exception as e:  # no package, no credentials, no network
            self._run = None
            self._wandb = None
            self._reason = str(e)

    @property
    def active(self) -> bool:
        return self._run is not None

    @property
    def reason(self) -> Optional[str]:
        """Why the sink is inactive (None when it is active)."""
        return self._reason

    def log(self, step: int, metrics: Dict[str, float]):
        if self._run is not None:
            self._wandb.log(metrics, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
