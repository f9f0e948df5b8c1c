"""Twin MQ stacks for the port's broker tests (tests/test_torch_mq.py,
tests/test_torch_mq_multibroker.py, tests/test_torch_mq_broker_parity.py).

`PKGS[name]` holds one package's MQ modules and the servers a broker
stands on; `Stack` is one package's cluster (a master, a volume server on
its CPU backend and a filer over a memory store, served over HTTP), the
filer a broker keeps its segments, `topic.conf`, `offsets.json` and
`schema.json` in. `filer_file` reads a file of that filer back, so the
two packages' brokers are compared by the bytes they wrote.
"""

import http.client
import json
import types
import urllib.parse

from conftest import wait_for
from test_torch_volume_server import _ports

import seaweedfs_tpu.filer.notification as j_notification
import seaweedfs_tpu.mq as j_mq
import seaweedfs_tpu.mq.agent as j_agent
import seaweedfs_tpu.mq.balancer as j_balancer
import seaweedfs_tpu.mq.broker as j_broker
import seaweedfs_tpu.mq.client as j_client
import seaweedfs_tpu.mq.log_buffer as j_log_buffer
import seaweedfs_tpu.mq.logstore as j_logstore
import seaweedfs_tpu.pb.mq_pb2 as j_pb
import seaweedfs_tpu.pb.rpc as j_rpc
import seaweedfs_tpu.shell.commands as j_shell
from seaweedfs_tpu.filer import Filer as JaxFiler
from seaweedfs_tpu.filer import MemoryStore as JaxMemoryStore
from seaweedfs_tpu.server.filer_server import FilerServer as JaxFilerServer
from seaweedfs_tpu.server.master import MasterServer as JaxMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JaxVolumeServer
import seaweedfs_tpu_torch.filer.notification as p_notification
import seaweedfs_tpu_torch.mq as p_mq
import seaweedfs_tpu_torch.mq.agent as p_agent
import seaweedfs_tpu_torch.mq.balancer as p_balancer
import seaweedfs_tpu_torch.mq.broker as p_broker
import seaweedfs_tpu_torch.mq.client as p_client
import seaweedfs_tpu_torch.mq.log_buffer as p_log_buffer
import seaweedfs_tpu_torch.mq.logstore as p_logstore
import seaweedfs_tpu_torch.pb.mq_pb2 as p_pb
import seaweedfs_tpu_torch.pb.rpc as p_rpc
import seaweedfs_tpu_torch.shell.commands as p_shell
from seaweedfs_tpu_torch.filer import Filer, MemoryStore
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", mq=j_mq, agent=j_agent, balancer=j_balancer, broker=j_broker,
        client=j_client, log_buffer=j_log_buffer, logstore=j_logstore, pb=j_pb, rpc=j_rpc,
        shell=j_shell, notification=j_notification, master=JaxMasterServer,
        volume=JaxVolumeServer, filer=JaxFiler, memory=JaxMemoryStore,
        filer_server=JaxFilerServer),
    "port": types.SimpleNamespace(
        name="port", mq=p_mq, agent=p_agent, balancer=p_balancer, broker=p_broker,
        client=p_client, log_buffer=p_log_buffer, logstore=p_logstore, pb=p_pb, rpc=p_rpc,
        shell=p_shell, notification=p_notification, master=MasterServer, volume=VolumeServer,
        filer=Filer, memory=MemoryStore, filer_server=FilerServer),
}


class Stack:
    """One package's cluster and filer; `filer_addr` is what a broker of
    that package takes as its `filer`."""

    def __init__(self, name: str, root):
        self.pkg = pkg = PKGS[name]
        self.mport = _ports()
        self.master = pkg.master(ip="127.0.0.1", port=self.mport, vacuum_interval=3600)
        self.master.start()
        self.vs = pkg.volume([str(root / "v")], master=f"127.0.0.1:{self.mport}", ip="127.0.0.1",
                             port=_ports(), ec_backend="cpu", max_volume_count=20)
        self.vs.start()
        wait_for(lambda: self.master.topo.nodes, timeout=30, msg=f"the {name} server registered")
        self.filer = pkg.filer(pkg.memory(), master=f"127.0.0.1:{self.mport}")
        self.fport = _ports()
        self.fsrv = pkg.filer_server(self.filer, ip="127.0.0.1", port=self.fport)
        self.fsrv.start()

    @property
    def filer_addr(self) -> str:
        return f"127.0.0.1:{self.fport}"

    def stop(self):
        self.fsrv.stop()
        self.filer.close()
        self.vs.stop()
        self.master.stop()


def filer_file(stack: Stack, path: str):
    """A file's bytes at the stack's filer, None where it is absent."""
    c = http.client.HTTPConnection("127.0.0.1", stack.fport, timeout=60)
    try:
        c.request("GET", urllib.parse.quote(path))
        r = c.getresponse()
        body = r.read()
        if r.status == 404 or r.getheader("X-Filer-Listing") == "true":
            return None
        assert r.status == 200, (path, r.status)
        return body
    finally:
        c.close()


def topic_files(stack: Stack, ns: str, name: str) -> dict:
    """Every file under /topics/<ns>/<name> at the stack's filer: path
    below the topic -> bytes (parquet files by their decoded segment)."""
    out, todo = {}, [f"/topics/{ns}/{name}"]
    while todo:
        d = todo.pop()
        last = ""
        while True:
            c = http.client.HTTPConnection("127.0.0.1", stack.fport, timeout=60)
            try:
                c.request("GET", urllib.parse.quote(d) + "?" + urllib.parse.urlencode(
                    {"limit": "1024", "lastFileName": last}))
                r = c.getresponse()
                body = r.read()
            finally:
                c.close()
            if r.status == 404:
                break
            page = json.loads(body)
            entries = page.get("Entries") or []
            for e in entries:
                if e["IsDirectory"]:
                    todo.append(e["FullPath"])
                else:
                    raw = filer_file(stack, e["FullPath"])
                    rel = e["FullPath"][len(f"/topics/{ns}/{name}/"):]
                    if rel.endswith(".parquet"):
                        raw = stack.pkg.logstore.parquet_to_segment(raw)
                    out[rel] = raw
            if not page.get("ShouldDisplayLoadMore") or not entries:
                break
            last = entries[-1]["FullPath"].rsplit("/", 1)[-1]
    return dict(sorted(out.items()))
