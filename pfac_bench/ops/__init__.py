"""The operations of the program that a traffic mix can drive, one file
each (``ops/<op>.py``). Each file has:

* ``Op(matcher, device, slots)``: ``call(batch)`` makes the call and
  returns its outputs; ``readback(out, slot)`` queues what the host must
  read before it knows the result is complete; ``complete(out, slot)``,
  once that has arrived, returns the matches the result holds (or None
  where the operation does not say);
* ``compare(out, ref, n)``: the numbers that decide ``correct`` for one
  output against the reference's dense result ``ref`` (int32[n]);
* ``LIMITS``: each of those numbers' limit.
"""
