"""Storage-dtype accounting. The port stores cold bundles in fp16 only;
quantized storage is a later slice."""
