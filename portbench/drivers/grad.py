"""Source gradients of the frozen loss: a closed loop calling the loss
function that losses.dpdist_loss.make_frozen_dpdist_loss returns on a
batch of (template, source) pairs and differentiating it in the source
only, as registration and the AUE do; the host reads the loss back after
every call.

The program's route runs, per direction, row 2 (the table gather,
csrc/table_gather.cu) on the plain encode's volume, the float32 decoder,
and backwards the decoder's input-gradient GEMMs, row 3 (the adjoint
gather) into the source's volume and the plain encode's backward. The
check compares every call's loss and source gradient with the plain
reference's autograd on its pairs.
"""

from __future__ import annotations

import torch

from portbench.core import counts
from portbench.core.pairs import PairDriver


class Driver(PairDriver):
    def setup(self):
        from dpdist_tpu_torch.losses.dpdist_loss import make_frozen_dpdist_loss

        self.load()
        self.penalty = self.ctx.traffic["out_of_grid_penalty"]
        self.loss_fn = make_frozen_dpdist_loss(self.params, self.dcfg,
                                               out_of_grid_penalty=self.penalty)
        self.sources = [s.clone().requires_grad_(True) for s in self.src]
        self.warm_up()

    def step(self, i):
        j, spans = self.batch(i), self.ctx.spans
        src = self.sources[j]
        with spans("entry"):
            loss = self.loss_fn(self.tmpl[j], src)
            (grad,) = torch.autograd.grad(loss, src)
        with spans("readback"):
            value = loss.item()
        self.failed += int(not torch.isfinite(loss))
        self.answers.append((j, value, grad))

    def step_flops(self):
        B, N = self.ctx.traffic["batch"], self.ctx.traffic["num_point"]
        return counts.grad_call_flops(self.ctx.config, B, N)

    def kernel_work(self, kernel, step):
        B, N, G, C, E = self.shape()
        j = self.batch(step)
        V = G
        if kernel == "table_gather_x":
            works = [counts.row2_work(B, N, V, C, E, self.windows(j, q)[0]) for q in ("src", "tmpl")]
            return sum(w[0] for w in works), sum(w[1] for w in works)
        if kernel == "table_gather_bwd":
            # The adjoint scatters into the source's volume, which the
            # template's points query.
            return counts.row3_work(B, N, V, C, self.windows(j, "tmpl")[1])
        return None

    def _expected(self, kind, batches):
        """{batch: (loss, source gradient)} of the reference."""
        net, arith = self.net(), self.arith(kind)
        out = {}
        with arith:
            for j in batches:
                src = self.src[j].detach().clone().requires_grad_(True)
                loss = net.frozen_loss(arith, self.tmpl[j], src, self.penalty)
                out[j] = (loss.item(), torch.autograd.grad(loss, src)[0])
        return out

    @staticmethod
    def _gaps(answers, want):
        """loss_gap: the largest |loss - reference| of a call; grad_gap: the
        largest ||grad - reference|| / ||reference|| of a call."""
        loss_gap = grad_gap = 0.0
        for j, value, grad in answers:
            v_ref, g_ref = want[j]
            loss_gap = max(loss_gap, abs(value - v_ref))
            grad_gap = max(grad_gap, float((grad - g_ref).norm() / g_ref.norm()))
        return {"loss_gap": loss_gap, "grad_gap": grad_gap}

    def check(self):
        return self._gaps(self.answers, self._expected("float32", self.answered()))

    def control(self):
        batches = range(self.pool)
        got = self._expected("tf32", batches)
        return self._gaps([(j, v, g) for j, (v, g) in got.items()],
                          self._expected("float32", batches))

    def release(self):
        super().release()
        self.__dict__.pop("sources", None)
