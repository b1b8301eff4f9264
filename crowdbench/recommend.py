"""The reference application's recommendation rules
(utils/recommendations.py:1-190), frozen here for the reference: a
threshold cascade over the density and flow results giving issues,
actions (with steps) and opportunities."""

from __future__ import annotations

from typing import Dict

_HOTSPOT_CRITICAL_STEPS = [
    "Deploy additional staff to redirect crowd flow away from this area",
    "Consider temporarily restricting entry to this zone until density "
    "decreases",
    "Use PA announcements to encourage people to move to less crowded areas",
    "Open alternative pathways to reduce flow through this bottleneck",
]
_HOTSPOT_HIGH_STEPS = [
    "Increase staff presence in this area to monitor crowd behavior",
    "Create one-way flow systems to prevent counterflow and congestion",
    "Consider timed entry or pulsed admission to this area",
    "Provide clear signage directing to alternative routes",
]
_VENUE_DENSITY_STEPS = [
    "Temporarily restrict new entries until density decreases",
    "Open additional space if available",
    "Implement timed entry/exit systems",
    "Consider early closing of certain areas to gradually disperse crowds",
]
_BOTTLENECK_CRITICAL_STEPS = [
    "Deploy staff to actively manage crowd flow through this area",
    "Implement one-way system to prevent counterflow",
    "Consider widening the pathway if physically possible",
    "Temporarily close this route and redirect traffic if alternative "
    "routes are available",
]
_BOTTLENECK_SIGNIFICANT_STEPS = [
    "Mark clear lanes with floor tape or portable barriers",
    "Position staff to guide crowd movement",
    "Use signage to indicate expected flow direction",
    "Remove any temporary obstacles if present",
]
_SLOW_FLOW_STEPS = [
    "Review and optimize venue layout to reduce obstructions",
    "Implement clear one-way systems in high-traffic areas",
    "Consider staggered scheduling for different activities",
    "Use staff to identify and quickly resolve developing bottlenecks",
]


def recommendations(density_results: Dict, flow_results: Dict,
                    rc: Dict) -> Dict:
    """Threshold cascade (utils/recommendations.py:1-190), its thresholds
    from the configuration file's ``recommend`` settings."""
    rec = {"issues": [], "actions": [], "opportunities": []}

    for i, h in enumerate(density_results.get("hotspots", [])):
        loc = f'({h["x"]:.1f}, {h["y"]:.1f})'
        if h["density"] > rc["hotspot_critical_density"]:
            rec["issues"].append({
                "title": f"Critical crowd density at location {i + 1}",
                "severity": min(10, int(h["density"] * 2)),
                "location": loc,
                "description": (
                    f"Extremely high crowd density of {h['density']:.2f} "
                    "people/m² detected. This exceeds safety thresholds "
                    "and creates significant safety risks."),
            })
            rec["actions"].append({
                "title": f"Reduce density at hotspot {i + 1}",
                "priority": "High",
                "description": (
                    "Immediate action required to reduce crowd density in "
                    "this area to prevent potential safety incidents."),
                "steps": list(_HOTSPOT_CRITICAL_STEPS),
            })
        elif h["density"] > rc["hotspot_high_density"]:
            rec["issues"].append({
                "title": f"High crowd density at location {i + 1}",
                "severity": min(8, int(h["density"] * 2)),
                "location": loc,
                "description": (
                    f"High crowd density of {h['density']:.2f} people/m² "
                    "detected. This is approaching unsafe levels and "
                    "requires attention."),
            })
            rec["actions"].append({
                "title": f"Manage crowd at hotspot {i + 1}",
                "priority": "Medium",
                "description": (
                    "Action required to prevent further density increase "
                    "and maintain safe conditions."),
                "steps": list(_HOTSPOT_HIGH_STEPS),
            })

    if density_results.get("avg_density", 0.0) > rc["venue_avg_density"]:
        avg = density_results["avg_density"]
        rec["issues"].append({
            "title": "Overall crowd density too high",
            "severity": min(9, int(avg * 2)),
            "location": "Entire venue",
            "description": (
                f"The average crowd density of {avg:.2f} people/m² "
                "across the venue exceeds comfortable levels. This creates "
                "risk of overcrowding throughout the venue."),
        })
        rec["actions"].append({
            "title": "Implement venue-wide density management",
            "priority": "High",
            "description": ("Take immediate steps to reduce overall crowd "
                            "density throughout the venue."),
            "steps": list(_VENUE_DENSITY_STEPS),
        })

    for i, b in enumerate(flow_results.get("bottlenecks", [])):
        loc = f'({b["x"]:.1f}, {b["y"]:.1f})'
        if b["severity"] >= rc["bottleneck_critical_severity"]:
            rec["issues"].append({
                "title": f"Critical flow bottleneck at location {i + 1}",
                "severity": b["severity"],
                "location": loc,
                "description": (
                    "Severe crowd flow constriction detected with high risk "
                    "of crowd compression and potential safety issues."),
            })
            rec["actions"].append({
                "title": f"Resolve critical bottleneck {i + 1}",
                "priority": "High",
                "description": (
                    "Immediate action required to resolve this flow "
                    "bottleneck and prevent potential crowd crush "
                    "incidents."),
                "steps": list(_BOTTLENECK_CRITICAL_STEPS),
            })
        elif b["severity"] >= rc["bottleneck_significant_severity"]:
            rec["issues"].append({
                "title": f"Flow bottleneck at location {i + 1}",
                "severity": b["severity"],
                "location": loc,
                "description": (
                    "Crowd flow bottleneck detected that is causing "
                    "congestion and reduced movement speed."),
            })
            rec["actions"].append({
                "title": f"Improve flow at bottleneck {i + 1}",
                "priority": "Medium",
                "description": (
                    "Action required to improve crowd flow through this "
                    "area and prevent crowding."),
                "steps": list(_BOTTLENECK_SIGNIFICANT_STEPS),
            })

    if flow_results.get("avg_speed", 1.0) < rc["slow_flow_speed"]:
        speed = flow_results["avg_speed"]
        rec["issues"].append({
            "title": "Slow overall crowd movement",
            "severity": min(7, int((0.7 - speed) * 10)),
            "location": "Entire venue",
            "description": (
                f"Average crowd movement speed of {speed:.2f} m/s is below "
                "optimal levels, indicating potential congestion throughout "
                "venue."),
        })
        rec["actions"].append({
            "title": "Improve overall crowd flow",
            "priority": "Medium",
            "description": ("Implement strategies to improve movement "
                            "throughout the venue."),
            "steps": list(_SLOW_FLOW_STEPS),
        })

    rec["opportunities"] = [
        {
            "title": "Identify and utilize low-density areas",
            "impact": "Medium",
            "description": (
                "Areas with consistently low crowd density represent an "
                "opportunity to better distribute attendees and reduce "
                "pressure on high-density zones. Consider relocating "
                "popular attractions or services to these areas."),
        },
        {
            "title": "Dynamic information systems",
            "impact": "High",
            "description": (
                "Implement real-time digital signage showing crowd density "
                "in different areas. This allows attendees to make informed "
                "decisions about which areas to visit, naturally balancing "
                "crowd distribution."),
        },
        {
            "title": "Optimize crowd flow patterns",
            "impact": "High",
            "description": (
                "The dominant crowd direction is "
                + flow_results.get("dominant_direction", "N/A")
                + ". Design the venue layout to work with this natural flow "
                "direction rather than against it to reduce congestion and "
                "improve attendee experience."),
        },
        {
            "title": "Improved entry/exit management",
            "impact": "Medium",
            "description": (
                "Consider implementing timed entry tickets or dynamic entry "
                "control based on real-time density data to prevent "
                "overcrowding from occurring in the first place."),
        },
    ]
    return rec
