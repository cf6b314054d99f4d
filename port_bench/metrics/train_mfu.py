"""train_mfu: model FLOPs of the train steps of the traced window over
its seconds and the bf16 dense peak, in per cent."""

from harness.readers import mfu


def read(run):
    return mfu(run)
