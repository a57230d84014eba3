"""Scoring: a closed loop of one client calling serving.FrozenDistance on
a batch of (template, source) pairs under inference mode and reading the
(B,) distances back to the host after every call.

At <= 128 points the program's route runs row 1 (the fused encode and
gather, csrc/mfv_gather.cu) once over the 2B stack, above it row 7 (the
streaming encode, csrc/threedmfv.cu) for each cloud and row 6 (the
patch-only gather, csrc/table_gather.cu) for each direction, then the
float32 decoder in cuBLAS. The check compares every distance the window
returned with the plain reference's for its pair.
"""

from __future__ import annotations

import torch

from portbench.core import counts
from portbench.core.pairs import PairDriver


class Driver(PairDriver):
    def setup(self):
        from dpdist_tpu_torch.serving import FrozenDistance

        self.load()
        self.model = FrozenDistance(self.dcfg, self.params, None).eval()
        self.warm_up()

    def step(self, i):
        j, spans = self.batch(i), self.ctx.spans
        with torch.inference_mode():
            with spans("entry"):
                d = self.model(self.tmpl[j], self.src[j])
            with spans("readback"):
                d = d.cpu()
        self.failed += int(not torch.isfinite(d).all())
        self.answers.append((j, d))

    def step_flops(self):
        B, N = self.ctx.traffic["batch"], self.ctx.traffic["num_point"]
        return counts.serve_call_flops(self.ctx.config, B, N)

    def kernel_work(self, kernel, step):
        B, N, G, C, E = self.shape()
        j = self.batch(step)
        if kernel == "mfv_gather_x":
            return counts.row1_work(2 * B, N, G, E)
        if kernel == "threedmfv":
            nbytes, flops = counts.row7_work(B, N, G, C)
            return 2 * nbytes, 2 * flops
        if kernel == "table_gather_rows":
            works = [counts.row6_work(B, N, C, E, self.windows(j, q)[0]) for q in ("src", "tmpl")]
            return sum(w[0] for w in works), 0
        return None

    def _expected(self, kind, batches):
        net, arith = self.net(), self.arith(kind)
        with torch.no_grad(), arith:
            return {j: net.distances(arith, self.tmpl[j], self.src[j]).cpu() for j in batches}

    @staticmethod
    def _gap(answers, want):
        return {"dist_gap": max(float((d - want[j]).abs().max()) for j, d in answers)}

    def check(self):
        return self._gap(self.answers, self._expected("float32", self.answered()))

    def control(self):
        batches = range(self.pool)
        return self._gap(list(self._expected("tf32", batches).items()),
                         self._expected("float32", batches))
