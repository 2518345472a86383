"""Host wall of ``session.pack(...)``: placement on the host, then the
4-bit packs on the card (synchronised)."""


def read(run):
    return run["spans"]["pack"]
