"""The LM path of the port: layers, attention, the decoders (attention,
mixture-of-experts, RWKV-6 and RG-LRU blocks), the Whisper
encoder-decoder and their ``Model`` facade (counterpart of
``repro.models``)."""
