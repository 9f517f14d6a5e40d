"""The event-centric SPE baseline the paper compares TiLT with (numpy
only; a copy of ``repro.spe``)."""
