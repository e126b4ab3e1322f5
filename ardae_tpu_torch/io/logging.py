"""Dual-sink logging: stdout + {exp_dir}/log.txt, plus a tensorboard writer
when tensorboardX is installed (JAX twin: ardae_tpu/io/logging.py; reference
utils/msc.py:117-127)."""

import datetime
import os

# set in the processes of a mesh's ranks 1..N-1 (cli drivers), whose rank 0
# writes the run's log: logging is then a no-op in that process
_SILENT = []


def silence():
    """No logging from this process from now on."""
    _SILENT.append(True)


def logging(s: str, path=None, filename: str = "log.txt"):
    if _SILENT:
        return
    print(s, flush=True)
    if path is not None:
        with open(os.path.join(path, filename), "a+") as f:
            f.write(s + "\n")


def get_time() -> str:
    return datetime.datetime.now().strftime("%y%m%d-%H:%M:%S")


class _NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def add_histogram(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def make_writer(path: str):
    """tensorboardX SummaryWriter, or a no-op stub where it is not installed
    (torch.utils.tensorboard would import TensorFlow, seconds per run)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return _NullWriter()
    return SummaryWriter(path)
