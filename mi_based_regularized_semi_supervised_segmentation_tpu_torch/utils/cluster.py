"""Cluster job submission — the reference's Compute-Canada helper
(WHEEL::deepclustering2/cchelper/job_submiter.py: sbatch_script_prefix +
JobSubmiter), a copy of the JAX package's ``utils/cluster.py`` for the
PyTorch port, re-expressed testably: script GENERATION is pure (inspectable,
unit-tested without SLURM), submission shells out to ``sbatch`` when present
and falls back to local bash when ``on_local`` — the same dual mode the
reference had.

Same parameter surface: account, time (hours), job_name, nodes, gres,
cpus_per_task, mem (GB), mail_user; ``prepare_env`` commands are emitted
before the payload command.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence


def sbatch_script_prefix(
    account: str,
    time: int = 1,
    job_name: str = "default_jobname",
    nodes: int = 1,
    gres: str = "gpu:1",
    cpus_per_task: int = 6,
    mem: int = 16,
    mail_user: Optional[str] = None,
) -> str:
    """#SBATCH preamble with the reference's option set (job_submiter.py:
    sbatch_script_prefix); ``gres`` (one GPU by default) stays overridable
    for other queues."""
    lines = [
        "#!/bin/bash",
        f"#SBATCH --time=0-{time}:00",
        f"#SBATCH --account={account}",
        f"#SBATCH --cpus-per-task={cpus_per_task}",
        f"#SBATCH --gres={gres}",
        f"#SBATCH --job-name={job_name}",
        f"#SBATCH --nodes={nodes}",
        f"#SBATCH --mem={mem}000M",
    ]
    if mail_user:
        lines += [f"#SBATCH --mail-user={mail_user}", "#SBATCH --mail-type=ALL"]
    return "\n".join(lines) + "\n"


class JobSubmiter:
    """Build + submit batch scripts. ``prepare_env``: setup commands (module
    loads, venv activation) emitted before the payload."""

    def __init__(self, project_path: str = "./", on_local: bool = False,
                 account: str = "", prepare_env: Sequence[str] = (),
                 **sbatch_kwargs) -> None:
        self._project_path = project_path
        self._on_local = bool(on_local)
        self._account = account
        self._env = list(prepare_env)
        self._sbatch_kwargs = dict(sbatch_kwargs)

    def script_for(self, cmd: str) -> str:
        prefix = sbatch_script_prefix(self._account, **self._sbatch_kwargs)
        body = "\n".join([f"cd {self._project_path}", *self._env, cmd])
        return prefix + body + "\n"

    def run(self, cmd: str) -> int:
        """Submit ``cmd``; returns the child's return code. Local mode (or
        no sbatch on PATH) executes the script body with bash."""
        script = self.script_for(cmd)
        with tempfile.NamedTemporaryFile(
                "w", suffix=".sh", delete=False) as f:
            f.write(script)
            path = f.name
        try:
            if not self._on_local and shutil.which("sbatch"):
                return subprocess.call(["sbatch", path])
            return subprocess.call(["bash", path])
        finally:
            Path(path).unlink(missing_ok=True)
