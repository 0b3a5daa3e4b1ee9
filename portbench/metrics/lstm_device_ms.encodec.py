"""lstm_device_ms.encodec: device ms per batch in which the card runs an
operation launched inside the program's ``encoder.lstm`` and
``decoder.lstm`` spans in EnCodec (each a 2-layer SLSTM of 512 over the
batch's frames, its permutes and skip;
``esc_tpu_torch/baselines/encodec/layers.py::SLSTM``), in the traced
batches: the operations' intervals merged (:func:`portbench.busy.busy_ms`),
since cuDNN runs some of them side by side. At most the LSTM's part of
``encoder_device_ms.encodec`` and ``decoder_device_ms.encodec``, which add
up durations."""

from portbench.busy import busy_ms


def read(run):
    if "Encodec" not in run.config:
        return None
    return busy_ms(run, "encoder.lstm", "decoder.lstm")
