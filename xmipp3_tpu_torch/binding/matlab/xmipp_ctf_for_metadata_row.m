function ctfFilter = xmipp_ctf_for_metadata_row(rowNumber, Xdim, Tm)
%XMIPP_CTF_FOR_METADATA_ROW build the CTF filter for row ROWNUMBER of the
%global metadata struct `md` (from xmipp_read_metadata) at image size
%Xdim and pixel size Tm. Mirrors the reference M utility.
global md
p = struct();
p.DeltafU = md.ctfDefocusU(rowNumber);
if isfield(md, 'ctfDefocusV'), p.DeltafV = md.ctfDefocusV(rowNumber); end
if isfield(md, 'ctfDefocusAngle')
    p.AzimuthalAngle = md.ctfDefocusAngle(rowNumber);
end
if isfield(md, 'ctfVoltage'), p.kV = md.ctfVoltage(rowNumber); end
if isfield(md, 'ctfSphericalAberration')
    p.Cs = md.ctfSphericalAberration(rowNumber);
end
if isfield(md, 'ctfQ0'), p.Q0 = md.ctfQ0(rowNumber); end
ctfFilter = xmipp_ctf_generate_filter(Xdim, Tm, p);
end
