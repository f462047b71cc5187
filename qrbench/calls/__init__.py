"""One module a call: what a traffic mix's ``"call"`` names.

A module ``calls/<name>.py`` holds everything of one entry of the
program's API that the harness needs, so that a cell on a new entry or
mode is added by files alone:

  BACKWARD                     the number of ``numbers`` that the
                               end-to-end metric backward_error reports
  make(tq, cfg, args)          fn(a) → the program's raw result, from the
                               ``tileqr_torch`` module, its ``QRConfig``
                               and the traffic's ``"args"``
  answer(out)                  the raw result as the tensors judged
  flops(shape)                 the LAPACK flops of one call on an input
                               of the configuration's shape (``lawn41``)
  least_bytes(shape, itemsize) the input read once, the answer written once
  truth(ref, a)                the plain reference's float64 result on a,
                               worked out once an input (R for every QR)
  numbers(a, answer, truth)    the float64 numbers of one answer
                               (``judge.py``), against the truth
  reference(ref, a, precision) the plain reference's own answer in
                               float32 at ``precision`` (the control)
"""
