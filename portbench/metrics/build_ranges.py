"""build_ranges: the ranges of consecutive keys that the run's device build
worked in, one pass over the sequences each after a survey pass
(program_counter: ``key_ranges`` of
sbwt_tpu_torch.construct.device.LAST_BUILD).

The harness passes a reader its record alone, so this reader imports the
program's build record inside ``read``. It returns None where the program
keeps no such record, and where the run timed no build (no ``build``
span), so that a run that built nothing reports no earlier build's
ranges."""


def read(run):
    from sbwt_tpu_torch.construct import device

    record = getattr(device, "LAST_BUILD", None)
    if not record or run["spans"].get("build") is None:
        return None
    return record.get("key_ranges")
