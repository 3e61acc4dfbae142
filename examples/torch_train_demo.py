"""Training driver on the PyTorch port: a small llama-family model on
the synthetic pipeline with delta-encoded checkpoint/restart (kill it
mid-run and re-launch: it resumes bit-exactly), on the CUDA card
(``--device cpu`` runs the kernels' plain versions on the host).

    PYTHONPATH=src python examples/torch_train_demo.py [--steps 300]
        [--device cpu]

``--crash-at N`` stops it at step N (exit 17, the launcher's fault
injection) to show the resume; ``--ckpt-every`` sets the checkpoint
interval.  The default checkpoint directory lies under the temporary
directory.
"""
import argparse
import contextlib
import io
import os
import sys
import tempfile

from repro_torch.launch import train as train_launch
from repro_torch.models.common import device_line, resolve_device


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to ``stream``."""

    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, s):
        self.stream.write(s)
        return super().write(s)


def launcher_argv(steps: int, ckpt_dir: str, ckpt_every: int = 50,
                  crash_at: int = -1, device=None) -> list:
    """The JAX demo's launcher arguments plus ``--device``."""
    argv = ["--arch", "llama3.2-1b", "--reduced",
            "--steps", str(steps),
            "--seq-len", "64", "--global-batch", "4",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", str(ckpt_every),
            "--log-every", "20", "--device", str(device)]
    if crash_at >= 0:
        argv += ["--crash-at", str(crash_at)]
    return argv


def run(steps: int = 200, ckpt_dir=None, ckpt_every: int = 50,
        crash_at: int = -1, device=None) -> str:
    """Train; returns the text it printed.  A run cut by ``crash_at``
    raises ``SystemExit(17)`` after printing."""
    device = resolve_device(device)
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_demo")
    out = _Tee(sys.stdout)
    with contextlib.redirect_stdout(out):
        print(device_line(device))
        train_launch.main(launcher_argv(steps, ckpt_dir, ckpt_every,
                                        crash_at, device))
    return out.getvalue().rstrip("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default) or cpu")
    args = ap.parse_args(argv)
    run(args.steps, args.ckpt_dir, args.ckpt_every, args.crash_at,
        device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
