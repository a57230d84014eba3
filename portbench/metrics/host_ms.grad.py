"""host_ms.grad: mean host ms of one call into the loss function of
losses.dpdist_loss.make_frozen_dpdist_loss and its autograd, up to its
return, before the read-back (the benchmark's own span)."""

from portbench.core import readers


def read(run):
    return readers.host_ms(run)
