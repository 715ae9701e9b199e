"""Blocks split over lanes of one or several devices (counterpart of
`nanorq_tpu.parallel`)."""
