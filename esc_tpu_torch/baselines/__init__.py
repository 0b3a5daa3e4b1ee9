"""Baseline codecs the paper compares ESC with (port of
``esc_tpu/baselines``): the Descript Audio Codec (:mod:`.dac`) and EnCodec
24 kHz (:mod:`.encodec`)."""
