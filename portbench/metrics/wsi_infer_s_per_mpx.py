"""The WSI engine's ``Inference Time`` log span (the inference loop; in
the resident loop it also holds each grid tile's nuclei), summed over the
window's slides, over their Mpx."""


def read(run):
    spans = [u["spans"].get("Inference Time") for u in run["units"]]
    if not spans or None in spans:
        return None
    return sum(spans) / run["window_mpx"]
