"""Group/Version/Kind <-> REST path mapping of the Kubernetes API (port
of the part of kserve_tpu/controlplane/gvk.py that the HTTP transport,
api/http_transport.py, needs): `Resource`, the table of built-in kinds,
`resource_from_crd` and the path helpers.  The rest of the control plane
is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional


class Resource(NamedTuple):
    kind: str
    group: str       # "" for the core group
    version: str
    plural: str
    namespaced: bool


def _r(kind, group, version, plural, namespaced=True) -> Resource:
    return Resource(kind, group, version, plural, namespaced)


# kind -> Resource.  One version per kind (the stub serves one).
BUILTIN_RESOURCES: Dict[str, Resource] = {r.kind: r for r in [
    # core/v1
    _r("Pod", "", "v1", "pods"),
    _r("Service", "", "v1", "services"),
    _r("ConfigMap", "", "v1", "configmaps"),
    _r("Secret", "", "v1", "secrets"),
    _r("ServiceAccount", "", "v1", "serviceaccounts"),
    _r("Event", "", "v1", "events"),
    _r("Node", "", "v1", "nodes", namespaced=False),
    _r("Namespace", "", "v1", "namespaces", namespaced=False),
    _r("PersistentVolume", "", "v1", "persistentvolumes", namespaced=False),
    _r("PersistentVolumeClaim", "", "v1", "persistentvolumeclaims"),
    # workloads
    _r("Deployment", "apps", "v1", "deployments"),
    _r("StatefulSet", "apps", "v1", "statefulsets"),
    _r("Job", "batch", "v1", "jobs"),
    # autoscaling
    _r("HorizontalPodAutoscaler", "autoscaling", "v2", "horizontalpodautoscalers"),
    _r("ScaledObject", "keda.sh", "v1alpha1", "scaledobjects"),
    # networking
    _r("HTTPRoute", "gateway.networking.k8s.io", "v1", "httproutes"),
    _r("Ingress", "networking.k8s.io", "v1", "ingresses"),
    _r("VirtualService", "networking.istio.io", "v1beta1", "virtualservices"),
    _r("InferencePool", "inference.networking.k8s.io", "v1", "inferencepools"),
    # observability
    _r("OpenTelemetryCollector", "opentelemetry.io", "v1beta1",
       "opentelemetrycollectors"),
    # rbac (the manager's own deploy manifest)
    _r("ClusterRole", "rbac.authorization.k8s.io", "v1", "clusterroles",
       namespaced=False),
    _r("ClusterRoleBinding", "rbac.authorization.k8s.io", "v1",
       "clusterrolebindings", namespaced=False),
    _r("Role", "rbac.authorization.k8s.io", "v1", "roles"),
    _r("RoleBinding", "rbac.authorization.k8s.io", "v1", "rolebindings"),
    # machinery
    _r("Lease", "coordination.k8s.io", "v1", "leases"),
    _r("CustomResourceDefinition", "apiextensions.k8s.io", "v1",
       "customresourcedefinitions", namespaced=False),
    _r("MutatingWebhookConfiguration", "admissionregistration.k8s.io", "v1",
       "mutatingwebhookconfigurations", namespaced=False),
    _r("ValidatingWebhookConfiguration", "admissionregistration.k8s.io", "v1",
       "validatingwebhookconfigurations", namespaced=False),
]}


def resource_from_crd(crd: dict) -> Optional[Resource]:
    """Resource served for an applied CustomResourceDefinition (the first
    served version, matching how the stub serves exactly one version)."""
    spec = crd.get("spec", {})
    names = spec.get("names", {})
    versions = [v for v in spec.get("versions", []) if v.get("served", True)]
    if not names.get("kind") or not names.get("plural") or not versions:
        return None
    return Resource(
        kind=names["kind"],
        group=spec.get("group", ""),
        version=versions[0]["name"],
        plural=names["plural"],
        namespaced=spec.get("scope", "Namespaced") == "Namespaced",
    )


def api_prefix(res: Resource) -> str:
    """/api/v1 for the core group, /apis/{group}/{version} otherwise."""
    if res.group == "":
        return f"/api/{res.version}"
    return f"/apis/{res.group}/{res.version}"


def collection_path(res: Resource, namespace: Optional[str]) -> str:
    prefix = api_prefix(res)
    if res.namespaced and namespace:
        return f"{prefix}/namespaces/{namespace}/{res.plural}"
    return f"{prefix}/{res.plural}"


def object_path(res: Resource, namespace: Optional[str], name: str) -> str:
    return f"{collection_path(res, namespace)}/{name}"


def api_version_of(res: Resource) -> str:
    return res.version if res.group == "" else f"{res.group}/{res.version}"
