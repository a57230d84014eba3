"""host_ms.train: mean host ms of one call into
train.aue_trainer.AUETrainer.train_step, up to its return, before the read-
back (the benchmark's own span)."""

from portbench.core import readers


def read(run):
    return readers.host_ms(run)
