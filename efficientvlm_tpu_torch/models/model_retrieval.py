"""Retrieval task model (ITC + ITM), teacher and student in one: the
student is the same forward with a zs dict; the teacher passes zs=None.

Evaluation runs through the XVLM methods and evaluation/retrieval.py; the
training forward (the losses) comes with the training slice.
"""

from __future__ import annotations

from .xvlm import XVLM


class XVLMForRetrieval(XVLM):
    pass
