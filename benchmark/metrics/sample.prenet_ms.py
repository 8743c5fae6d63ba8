"""Device ms a call of the feature encoder, ``NoiseToLatent`` and the
decoder's pre-net: the kernels launched in the benchmark's spans around the
first two and around the decoder, less those inside its span after the
pre-net (the cuBLAS GEMMs, the ReLUs, the channels-last copy; under bf16 the
rounding kernels too)."""

SPANS = ("feature_encoder", "noise_to_latent", "decoder")
TAIL = "decoder_tail"


def read(view):
    events = view.select(("kernel", "gpu_memcpy", "gpu_memset"), in_spans=SPANS, not_in_spans=(TAIL,))
    if not events or view.units == 0:
        return None
    return 1e3 * view.seconds(events) / view.units
