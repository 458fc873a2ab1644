"""Checkpoint rotation + failure handling for long training runs
(counterpart of ``repro.checkpoint.manager``).

- keeps the newest ``keep`` checkpoints, deleting older ones only after a
  newer one is durably visible (atomic rename in checkpoint.save);
- `latest()` scans for the newest VALID checkpoint, skipping half-written
  or corrupt directories — restart-after-crash just works;
- `WatchdogState` is the deterministic failover decision logic for
  multi-host runs: hosts heartbeat, stale hosts are declared dead after
  ``timeout_s``, and the survivor set maps to a (possibly smaller) data-
  parallel width. The transport (who pings whom) is deployment-
  specific; the DECISION logic here is what must be correct, so it is pure
  and unit-tested.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.models import base
from repro_torch.parallel import sharding


class CheckpointManager:
    """Saves and restores trees of tensors. With ``mesh`` (a
    ``launch.mesh.ProcessMesh``) and ``cfg``, the trees are ``cfg``'s
    parameters and AdamW state as ``parallel.sharding.shard_params`` placed
    them over the mesh, and every rank calls ``save`` and
    ``restore_latest``: ``save`` gathers the split leaves and rank 0 writes
    them whole, in the one-device format (either package, on any mesh,
    restores them); ``restore_latest`` reads them whole and keeps this
    rank's blocks."""

    def __init__(self, root: str | Path, *, keep: int = 3, interval: int = 100,
                 async_: bool = True, cfg=None, mesh=None):
        self.root = Path(root)
        self.keep = keep
        self.interval = interval
        self.async_ = async_
        self.cfg, self.mesh = cfg, mesh
        self._pending = None
        self.root.mkdir(parents=True, exist_ok=True)

    def dir_for(self, step: int) -> Path:
        return self.root / f"step_{step:010d}"

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def save(self, step: int, tree, extra: dict | None = None):
        if self.mesh is not None:
            tree = sharding.gather_params(tree, self.cfg, self.mesh)
            if dist.get_rank() != 0:
                return
        if self._pending is not None:
            self._pending()  # join previous async write
        self._pending = ckpt.save(self.dir_for(step), tree, step=step,
                                  extra=extra, async_=self.async_)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending()
            self._pending = None

    def _valid(self, d: Path) -> bool:
        try:
            json.loads((d / "manifest.json").read_text())
            return (d / "arrays.npz").exists()
        except Exception:
            return False

    def all_steps(self) -> list[int]:
        out = []
        for d in sorted(self.root.glob("step_*")):
            if self._valid(d):
                out.append(int(d.name.split("_")[1]))
        return out

    def latest(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, like_tree, device=None):
        """(step, tree, manifest) of the newest valid checkpoint, restored on
        ``device`` (CUDA unless the caller names one); None if there is none."""
        step = self.latest()
        if step is None:
            return None
        if self.mesh is None:
            tree, manifest = ckpt.restore(self.dir_for(step), like_tree, device=device)
            return step, tree, manifest
        # whole on the host, then this rank's blocks to the device
        whole = sharding.whole_like(like_tree, self.cfg, self.mesh)
        tree, manifest = ckpt.restore(self.dir_for(step), whole, device="cpu")
        tree = sharding.shard_params(tree, self.cfg, self.mesh)
        return step, base.tree_map(lambda t: t.to(device), tree), manifest

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            import shutil

            shutil.rmtree(self.dir_for(s), ignore_errors=True)


# ---------------------------------------------------------------------------
# Deterministic failover decision logic
# ---------------------------------------------------------------------------
@dataclass
class WatchdogState:
    n_hosts: int
    timeout_s: float = 60.0
    last_seen: dict[int, float] = field(default_factory=dict)

    def heartbeat(self, host: int, now: float):
        self.last_seen[host] = now

    def dead_hosts(self, now: float) -> list[int]:
        return [h for h in range(self.n_hosts)
                if now - self.last_seen.get(h, -1e18) > self.timeout_s]

    def plan(self, now: float, dp_width: int) -> dict:
        """Failover plan: survivors, new DP width (largest power-of-two
        <= survivors that divides the original width's host-per-replica
        grouping), and whether a restart is required."""
        dead = self.dead_hosts(now)
        alive = self.n_hosts - len(dead)
        new_dp = dp_width
        while new_dp > 1 and new_dp > alive:
            new_dp //= 2
        return {
            "dead": dead,
            "alive": alive,
            "restart_required": bool(dead),
            "new_dp_width": max(new_dp, 1),
            "action": "elastic_restart_from_latest_checkpoint" if dead else "none",
        }
