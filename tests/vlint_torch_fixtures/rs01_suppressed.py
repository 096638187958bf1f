"""Suppression fixture: a documented disable suppresses; a reasonless
one does not (and is itself reported as VL00)."""
import urllib.request


def post_documented(req):
    # vlint: disable=RS01 reason=fixture documents this raw egress
    return urllib.request.urlopen(req, timeout=5)


def post_reasonless(req):
    return urllib.request.urlopen(req, timeout=5)  # vlint: disable=RS01
