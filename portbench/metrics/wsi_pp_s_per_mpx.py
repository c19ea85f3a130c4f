"""The WSI engine's post-processing log spans (``Nuclei Post Proc Time``,
``Tissue Region Post Proc Time``, ``Gland & Lumen Post Proc Time``),
summed over the window's slides, over their Mpx."""

SPANS = ("Nuclei Post Proc Time", "Tissue Region Post Proc Time",
         "Gland & Lumen Post Proc Time")


def read(run):
    total = 0.0
    for unit in run["units"]:
        if any(name not in unit["spans"] for name in SPANS):
            return None
        total += sum(unit["spans"][name] for name in SPANS)
    return total / run["window_mpx"]
