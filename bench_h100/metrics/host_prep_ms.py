"""Host milliseconds a batch spends being cut to the crop's source
region (the benchmark's clock around ``apply_transport_crop``) and
placed on the card (the program's ``DevicePrefetcher``: its own seconds
for the pinned copy and the issue of the transfer), on the prefetcher's
worker thread, averaged over the batches of the run."""


def read(view):
    if view.kind != "batch":
        return None
    return view.host_prep_ms
