"""RS01 fixture: raw egress calls that bypass the resilience layer."""

import urllib.request

import grpc


def bad_http_post(req):
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status


def bad_grpc_channel(address):
    return grpc.insecure_channel(address)
