"""Tooling over the port (the counterpart of ``repro.analysis``).

``roofline`` holds the H100's peaks, the roofline report and every
kernel's work formula; ``op_cost`` counts a step's flops, bytes and op
census from torch; ``iraudit`` audits the captured serving steps on any
device without a card.
"""
