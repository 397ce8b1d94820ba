"""Broker daemon entry point: ``python -m mqtt_tpu_torch``.

A copy of the JAX package's ``python -m mqtt_tpu``, over the port's
``Server``.

The analog of the reference's config-file entry (cmd/docker/main.go:20-57)
plus the fork CLI ``go-mqttd`` (cmd/main.go): flags or a config file stand
up TCP/TLS/WebSocket/dashboard listeners, an auth ledger (YAML authfile,
optionally with obfuscated passwords) or allow-all auth, and the
subcommands ``initauth`` (sample authfile, cmd/main.go:131-140),
``code-password`` (obfuscate a password, cmd/main.go:141-154) and
``genecc`` (ECC certificate generation, cmd/main.go:155-185).

Deliberate deviation: the reference silently injects a hardcoded admin
user when an authfile is used (cmd/main.go:209-214). A baked-in credential
is a backdoor, so the same capability is exposed as the explicit
``--admin-user USER:PASS`` flag instead.

``--workers N`` (0 = one per CPU core) runs N worker processes, each a
full broker, that bind the MQTT ports with SO_REUSEPORT and join the
forwarding mesh (``cluster``) over a private socket directory; the
launcher re-executes ``python -m mqtt_tpu_torch`` with the worker
environment (``cluster.worker_env``) and touches no card itself. Only
worker 0 binds the HTTP listeners.

Departures from the JAX package's CLI: ``--device`` names the card the device planes run on (a config file's ``device`` otherwise;
``"cuda"`` by default). ``serve`` with a device plane on ``"cuda"`` and no
card exits at start naming the device: it never serves on the host.
``genecc`` imports ``cryptography`` only when it runs, and returns 1
without it.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import getpass
import json
import logging
import os
import signal
import socket
import ssl
import sys

from . import config as config_mod
from .hooks.auth import AllowHook, AuthHook, AuthOptions
from .hooks.auth.authfile import from_authfile, init_authfile
from .hooks.auth.ledger import RString, UserRule
from .listeners import Config as ListenerConfig, Dashboard, HTTPStats, TCP, Websocket
from .server import Options, Server
from .utils.obfuscate import obfuscate

VERSION_INFO = {"core": "mqtt_tpu_torch", "python": sys.version.split()[0]}
# the cluster worker environment the launcher sets (cluster.worker_env)
CLUSTER_ENV = "MQTT_TPU_WORKER"


def cmd_initauth(args) -> int:
    init_authfile(args.path)
    print(f"wrote sample authfile to {args.path}")
    return 0


def cmd_code_password(args) -> int:
    pwd = args.password or getpass.getpass("Password: ")
    print(obfuscate(pwd))
    return 0


def _local_ips() -> list[str]:
    ips = {"127.0.0.1"}
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None, socket.AF_INET):
            ips.add(info[4][0])
    except OSError:
        pass
    return sorted(ips)


def cmd_genecc(args) -> int:
    """Generate an ECC root CA plus a server certificate for localhost and
    the host's local IPs (cmd/main.go:155-185)."""
    try:
        import datetime
        import ipaddress

        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID
    except ImportError:
        print("genecc requires the 'cryptography' package", file=sys.stderr)
        return 1

    def write_key(path, key):
        with open(path, "wb") as f:
            f.write(
                key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.TraditionalOpenSSL,
                    serialization.NoEncryption(),
                )
            )

    def write_cert(path, cert):
        with open(path, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))

    now = datetime.datetime.now(datetime.timezone.utc)
    root_key = ec.generate_private_key(ec.SECP256R1())
    root_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "mqtt_tpu_torch root")])
    root_cert = (
        x509.CertificateBuilder()
        .subject_name(root_name)
        .issuer_name(root_name)
        .public_key(root_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=3650))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(root_key, hashes.SHA256())
    )

    leaf_key = ec.generate_private_key(ec.SECP256R1())
    sans = [x509.DNSName("localhost")] + [
        x509.IPAddress(ipaddress.ip_address(ip)) for ip in _local_ips()
    ]
    leaf_cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "mqtt_tpu_torch")]))
        .issuer_name(root_name)
        .public_key(leaf_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=3650))
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(root_key, hashes.SHA256())
    )

    write_key("root-key.ec.pem", root_key)
    write_cert("root.ec.pem", root_cert)
    write_key("cert-key.ec.pem", leaf_key)
    write_cert("cert.ec.pem", leaf_cert)
    print("done.")
    return 0


def build_server(args) -> Server:
    opts = None
    if args.config:
        opts = config_mod.from_file(args.config)
    if opts is None:
        opts = Options(inline_client=True)
    if args.msg_timeout:
        opts.capabilities.maximum_message_expiry_interval = args.msg_timeout
    if getattr(args, "device", None):
        opts.device = args.device
    try:
        server = Server(opts)
    except RuntimeError as e:
        # a device plane on a card that is not there: never serve on the host
        raise SystemExit(f"mqtt_tpu_torch: cannot start on device {opts.device!r}: {e}") from e
    from .hooks import ON_CONNECT_AUTHENTICATE

    has_auth = any(h.provides(ON_CONNECT_AUTHENTICATE) for h, _ in opts.hooks)
    if not has_auth:
        if args.disable_auth or not args.auth:
            server.add_hook(AllowHook())
        else:
            ledger = from_authfile(args.auth, args.coded_pwd)
            if args.admin_user:
                user, _, pwd = args.admin_user.partition(":")
                if ledger.users is None:
                    ledger.users = {}
                ledger.users.setdefault(
                    user, UserRule(username=RString(user), password=RString(pwd))
                )
            server.add_hook(AuthHook(), AuthOptions(ledger=ledger))

    # cluster workers share every MQTT-bearing port via SO_REUSEPORT; the
    # HTTP side-channels (dashboard, stats, healthcheck) show per-worker
    # state, so only worker 0 binds them
    clustered = os.environ.get(CLUSTER_ENV) is not None
    primary = not clustered or os.environ.get(CLUSTER_ENV) == "0"
    if not opts.listeners and len(server.listeners) == 0:
        server.add_listener(
            TCP(ListenerConfig(type="tcp", id="tcp", address=f":{args.port}", reuse_port=clustered))
        )
        if args.tls_port:
            if not (args.cert and args.key):
                raise SystemExit("--tls-port requires --cert and --key")
            tls = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            tls.load_cert_chain(args.cert, args.key)
            if args.rootca:
                tls.load_verify_locations(args.rootca)
            server.add_listener(
                TCP(
                    ListenerConfig(
                        type="tcp",
                        id="tls",
                        address=f":{args.tls_port}",
                        tls_config=tls,
                        reuse_port=clustered,
                    )
                )
            )
        if args.ws_port:
            server.add_listener(
                Websocket(
                    ListenerConfig(
                        type="ws", id="ws", address=f":{args.ws_port}", reuse_port=clustered
                    )
                )
            )
        if args.dashboard_port and primary:
            auth_map = {}
            if args.admin_user:
                user, _, pwd = args.admin_user.partition(":")
                auth_map[user] = pwd
            else:
                # the dashboard exposes client ids, usernames, remote IPs and
                # subscription filters — never serve it unauthenticated (the
                # reference fork's dashboard is always credentialed)
                raise SystemExit(
                    "--dashboard-port requires --admin-user USER:PASS "
                    "(the dashboard exposes connected-client details)"
                )
            server.add_listener(
                Dashboard(
                    ListenerConfig(type="dashboard", id="web", address=f":{args.dashboard_port}"),
                    server.info,
                    server.clients,
                    auth=auth_map,
                    listener_summary=f"mqtt: {args.port}; ws: {args.ws_port or '-'}",
                )
            )
        if args.stats_port and primary:
            server.add_listener(
                HTTPStats(
                    ListenerConfig(type="sysinfo", id="stats", address=f":{args.stats_port}"),
                    server.info,
                    # GET /metrics, /traces, /profile and /devices (404
                    # when Options.telemetry is off)
                    telemetry=server.telemetry,
                    health=server.health_report,
                )
            )
    return server


def _spawn_workers(argv: list, n: int) -> int:
    """Launcher for --workers N: re-exec this CLI once per worker with the
    cluster environment set; each worker binds the same ports with
    SO_REUSEPORT and joins the unix-socket mesh (cluster). ``argv`` is the
    effective argument list main() parsed. The launcher builds no server
    and touches no card."""
    import shutil
    import subprocess
    import tempfile
    import time

    from .cluster import worker_env

    # private (0700) socket directory: the mesh trusts every connection on it
    sock_dir = tempfile.mkdtemp(prefix="mqtt-torch-cluster-")

    # SIGTERM kills a Python process without unwinding finally blocks:
    # translate it to SystemExit so the cleanup below terminates the workers
    def _term(_sig, _frm):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _term)
    # strip --workers ("--workers N" and "--workers=N"): the children must
    # not recurse into the launcher
    cleaned = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--workers":
            skip = True
            continue
        if a.startswith("--workers="):
            continue
        cleaned.append(a)
    procs = []
    try:
        for i in range(n):
            env = dict(os.environ)
            env.update(worker_env(i, n, sock_dir))
            procs.append(
                subprocess.Popen([sys.executable, "-m", "mqtt_tpu_torch"] + cleaned, env=env)
            )
        # readiness: a worker that dies in its first seconds (port clash,
        # bad config, no card) fails the whole launch loudly
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            dead = [i for i, p in enumerate(procs) if p.poll() is not None]
            if dead:
                print(f"worker(s) {dead} exited during startup; aborting launch", file=sys.stderr)
                return 1
            time.sleep(0.1)
        rc = 0
        for p in procs:
            rc = p.wait() or rc
        return rc
    except KeyboardInterrupt:
        return 0
    finally:
        # a second SIGTERM must not abort this cleanup and orphan workers
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(sock_dir, ignore_errors=True)


def cmd_serve(args, argv: list) -> int:
    workers = getattr(args, "workers", 1)
    if workers == 0:
        workers = os.cpu_count() or 1
    if workers > 1 and os.environ.get(CLUSTER_ENV) is None:
        return _spawn_workers(argv, workers)
    if args.admin_user is not None:
        user, sep, pwd = args.admin_user.partition(":")
        if not user or not sep or not pwd:
            raise SystemExit("--admin-user must be USER:PASS with a non-empty password")
    level = args.log_level.upper()
    handlers = None
    if args.log2file:
        handlers = [logging.FileHandler(args.log2file), logging.StreamHandler()]
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
        handlers=handlers,
    )

    async def run() -> None:
        from .cluster import maybe_attach_from_env

        server = build_server(args)
        cluster = maybe_attach_from_env(server)
        await server.serve()
        if cluster is not None:
            await cluster.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        await stop.wait()
        if cluster is not None:
            await cluster.stop()
        # close() stops the hooks: a storage hook closes its store here
        await server.close()

    asyncio.run(run())
    # the store is closed: leave the heap (a restore holds a million
    # subscriptions) to the process's exit, not to a last full collection
    gc.freeze()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="mqtt_tpu_torch", description="MQTT broker with its device plane on PyTorch and CUDA"
    )
    parser.add_argument("--version", action="store_true", help="print version and exit")
    sub = parser.add_subparsers(dest="command")

    p_init = sub.add_parser("initauth", help="write a sample authfile")
    p_init.add_argument("path", nargs="?", default="auth.yaml")

    p_code = sub.add_parser("code-password", help="obfuscate a password for the authfile")
    p_code.add_argument("password", nargs="?", help="read interactively when omitted")

    sub.add_parser("genecc", help="generate ECC certificate files")

    # the serve subparser registers the same flags with SUPPRESS defaults:
    # flags given before the subcommand survive (a subparser default would
    # silently clobber them), flags after it still work
    serve = sub.add_parser(
        "serve", help="run the broker (default)", argument_default=argparse.SUPPRESS
    )
    for p, dflt in ((parser, None), (serve, argparse.SUPPRESS)):
        def arg(name, **kw):
            if dflt is argparse.SUPPRESS:
                kw.pop("default", None)
            p.add_argument(name, **kw)

        arg("--config", help="path to a YAML/JSON config file")
        arg("--auth", help="path to a YAML authfile")
        arg(
            "--coded-pwd",
            action="store_true",
            help="authfile passwords are obfuscated with THIS tool's "
            "code-password subcommand ($MOB$ scheme; NOT compatible with "
            "the Go fork's toolbox CodeString format)",
        )
        arg("--disable-auth", action="store_true", help="allow all clients")
        arg("--admin-user", help="USER:PASS granted broker + dashboard access")
        arg("--port", type=int, default=1883, help="MQTT TCP port")
        arg("--tls-port", type=int, default=0, help="MQTT TLS port")
        arg("--cert", help="TLS certificate file")
        arg("--key", help="TLS key file")
        arg("--rootca", help="TLS root CA file")
        arg("--ws-port", type=int, default=0, help="MQTT WebSocket port")
        arg("--stats-port", type=int, default=0, help="$SYS stats HTTP port")
        arg("--dashboard-port", type=int, default=0, help="status dashboard port")
        arg("--msg-timeout", type=int, default=0, help="message expiry seconds")
        arg(
            "--device",
            help="the card the device planes run on (cuda, cuda:N or cpu); "
            "default: the config file's device, else cuda",
        )
        arg(
            "--workers",
            type=int,
            default=1,
            help="broker worker processes sharing the MQTT ports via "
            "SO_REUSEPORT, joined by the forwarding mesh (cluster); 0 = one "
            "per CPU core",
        )
        arg("--log-level", default="info")
        arg("--log2file", help="also log to this file")
    effective_argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)

    if args.version:
        print(json.dumps(VERSION_INFO, indent=2))
        return 0
    if args.command == "initauth":
        return cmd_initauth(args)
    if args.command == "code-password":
        return cmd_code_password(args)
    if args.command == "genecc":
        return cmd_genecc(args)
    return cmd_serve(args, effective_argv)


if __name__ == "__main__":
    sys.exit(main())
