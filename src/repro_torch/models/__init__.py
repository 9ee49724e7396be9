"""The LM path of the port: layers, attention, the dense decoder and its
``Model`` facade (counterpart of ``repro.models`` for dense decoders)."""
