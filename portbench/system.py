"""The system under test: `bronko call` of the PyTorch and CUDA port, driven
in-process through its own parser and `run_call`.

The only module of the benchmark that imports the program. A call's
configuration comes from the argv a user would type (the port's `call`
parser); the index is read or built once, by `cli.run_call_cmd` itself,
and every call reuses it.
"""

from __future__ import annotations

import os
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    def __init__(self, config: dict, traffic: dict, strains: list[str], folder: str,
                 device: torch.device):
        from bronko_tpu_torch import cli
        from bronko_tpu_torch.config import setup_logging

        setup_logging(False, False)
        self.cli, self.device = cli, device
        self.k = int(config["k"])
        args = ["-k", str(self.k), *config.get("call_args", []), *traffic.get("call_args", [])]
        if config["index"] == "db":
            db = os.path.join(folder, f"index-k{self.k}.bkdb")
            if not os.path.exists(db):
                # `bronko build`, once per configuration and checkout
                tmp = f"{db[:-5]}.tmp"
                cli.main(["build", "-g", *strains, "-k", str(self.k), "-o", tmp])
                os.replace(f"{tmp}.bkdb", db)
            self.index_args = ["-d", db]
        elif config["index"] == "genomes":
            self.index_args = ["-g", *strains]
        else:
            raise ValueError(f"unknown index kind {config['index']!r}")
        self.args = args

    def config_for(self, pairs: list[tuple[str, str]], out: str):
        argv = ["call", *self.index_args, *self.args,
                "-1", *[a for a, _ in pairs], "-2", *[b for _, b in pairs], "-o", out]
        cfg = self.cli.call_config(self.cli.build_parser().parse_args(argv))
        cfg.validate()
        return cfg

    def load_index(self, cfg) -> float:
        """Read or build the index through `cli.run_call_cmd` itself, whose
        call of `run_call` is caught here: it hands over the index and the
        device index and runs no sample. Returns the seconds from the
        command's start to that hand-over, the device synchronised."""
        from bronko_tpu_torch.call import engine

        held = {}

        def hand_over(cfg_, index, dev, device):
            _sync(device)
            held.update(index=index, dev=dev, t=time.perf_counter())
            return [None] * (len(cfg_.reads) + len(cfg_.first_pairs))

        run_call, engine.run_call = engine.run_call, hand_over
        try:
            t0 = time.perf_counter()
            self.cli.run_call_cmd(cfg, self.device)
        finally:
            engine.run_call = run_call
        self.index, self.dev = held["index"], held["dev"]
        return held["t"] - t0

    def call(self, cfg):
        """One `run_call`; returns the samples that succeeded (SampleResult)."""
        from bronko_tpu_torch.call.engine import run_call

        try:
            return run_call(cfg, self.index, self.dev, self.device)
        except SystemExit:  # every sample failed
            return []

    def close(self) -> None:
        self.index = self.dev = None
