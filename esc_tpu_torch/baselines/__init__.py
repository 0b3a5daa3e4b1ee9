"""Baseline codecs the paper compares ESC with (port of
``esc_tpu/baselines``): the Descript Audio Codec (:mod:`.dac`)."""
