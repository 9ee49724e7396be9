"""Roofline cost model and autotuner of the port (``repro.roofline``'s
counterpart): :mod:`repro_torch.roofline.analysis` holds the H100's
machine description and the program counts, and
:mod:`repro_torch.roofline.autotune` the disk-cached knob search the
engine reads when ``PHConfig.autotune`` is on."""
