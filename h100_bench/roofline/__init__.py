"""Least times of the program's kernels, one module a kernel
(``roofline/<kernel>.py``), for the ``<kernel>_roofline`` metrics.

Each counts the work from the sample's own sizes (read bases, match runs,
contig positions, sites), never from the program's buffers: each input
byte read once and each output byte written once, at the card's 3.35 TB/s,
against the operations at their type's peak.  A metric reader divides the
least time by the device kernel time inside the stage's range, which the
traced samples mark with ``torch.profiler.record_function`` ranges named
``stage:<stage>`` (``trace.traced_samples``)."""
